"""The port imports no jax, flax or JAX-package module, and no triton, and
builds no CUDA library, when every module is imported (the RLE codec's
loader among them), its CPU path runs for the DVIS++ online, offline Swin,
offline ViT, MinVIS, CTVIS, Video Mask2Former and DVIS-DAQ online and
offline presets at a small size (the JAX default eval settings: ``runs``
download, threaded pipeline), its VPS and VSS loops run for the VIPSeg and
VSPW presets with their evaluators (PNGs by the port's own writer), DVIS-DAQ
runs the VPS loop, MOTS and the VOS writer, the three open-vocabulary
presets run ``run_ov_inference`` and the RN50 trunk the OV route of the VSS
loop, and its CLIs (``cli``; ``cli_ov --random-text``) evaluate the
synthetic YouTube-VIS set with ``--device cpu``, and ``cli`` trains DVIS++
online, MinVIS, CTVIS and DVIS++ offline on it, MinVIS with the
ViT-Adapter, DVIS-DAQ online and offline with the ViT-Adapter (their
curriculum cutting the clips), and Mask2Former and Video Mask2Former on a
synthetic COCO set made pseudo-videos, for two steps each (``metrics.jsonl``, a checkpoint). The rows are encoded by the native
codec, built with g++ on first use.

Runs in a subprocess: the pytest process itself has jax loaded (conftest).
The synthetic set is written by the pytest process (``tools/synth_data.py``
encodes its masks with the JAX package's codec)."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YAMLS = tuple(f"dvis/{n}" for n in (
    "dvis_online_r50_ytvis19", "minvis_r50_ytvis19", "ctvis_r50_ytvis19", "dvis_offline_r50_ytvis19",
    "minvis_vitl_ytvis19", "maskformer_r50_coco", "video_maskformer_r50_coco_joint")) + (
    "daq/daq_online_vitl_ytvis19", "daq/daq_offline_vitl_ytvis19")

SCRIPT = f"TRAIN_YAMLS = {TRAIN_YAMLS!r}\n" + r"""
import importlib, json, os, pkgutil, sys, tempfile
import numpy as np, torch
torch.set_num_threads(2)
import dvis_plus_tpu_torch
for m in pkgutil.walk_packages(dvis_plus_tpu_torch.__path__, "dvis_plus_tpu_torch."):
    importlib.import_module(m.name)

from dvis_plus_tpu_torch import cli
from dvis_plus_tpu_torch.config import (
    ctvis_r50_ytvis19, daq_offline_r50_ovis, daq_online_r50_ytvis19, dvis_offline_swinl_ytvis19,
    dvis_offline_vitl_ytvis19, dvis_online_r50_vipseg, dvis_online_r50_vspw, dvis_online_r50_ytvis19,
    minvis_r50_ytvis19, video_maskformer_r50_ytvis19,
)
from dvis_plus_tpu_torch.engine import daq_inference
from dvis_plus_tpu_torch.engine.inference import run_vis_inference, run_vps_inference, run_vss_inference
from dvis_plus_tpu_torch.evaluation.evaluators import (
    UniYTVISEvaluator, VPSEvaluator, VSSEvaluator, YTVISEvaluator,
)
from dvis_plus_tpu_torch.ops import _build, flash_attn, msdeform, swin_window_attn
from dvis_plus_tpu_torch.utils import rle

def small(cfg):
    m = cfg.model
    m.compute_dtype = "float32"
    m.backbone.vit_embed_dim = 32
    m.backbone.vit_depth = 2
    m.backbone.vit_num_heads = m.backbone.vit_deform_num_heads = 2
    m.backbone.vit_interaction_indexes = ((0, 0), (1, 1))
    m.backbone.vit_conv_inplane = 8
    m.backbone.vit_flash_attention = True
    m.backbone.name = m.backbone.name.replace("swin_l", "swin_tiny")
    m.backbone.swin_embed_dim = 32
    m.backbone.swin_depths = (1, 1, 1, 1)
    m.backbone.swin_num_heads = (1, 2, 4, 8)
    m.backbone.swin_window_size = 7
    m.pixel_decoder.conv_dim = m.pixel_decoder.mask_dim = 32
    m.pixel_decoder.transformer_enc_layers = 1
    m.pixel_decoder.transformer_dim_feedforward = 64
    m.transformer_decoder.hidden_dim = m.transformer_decoder.mask_dim = 32
    m.transformer_decoder.num_queries = 4
    m.transformer_decoder.nheads = 4
    m.transformer_decoder.dim_feedforward = 64
    m.transformer_decoder.dec_layers = 1
    m.transformer_decoder.reid_hidden_dim = 32
    m.tracker.num_layers = m.refiner.num_layers = 1
    m.tracker.feedforward_dim = m.refiner.feedforward_dim = 64
    m.daq.num_new_ins, m.daq.max_num_instances, m.daq.num_slots = 4, 3, 2
    cfg.test.window_size = 2
    torch.manual_seed(0)
    return cli.build_model(m).eval()

rows, containers, tasks = [], [], []
for preset in (dvis_online_r50_ytvis19, dvis_offline_swinl_ytvis19, dvis_offline_vitl_ytvis19,
               minvis_r50_ytvis19, ctvis_r50_ytvis19, video_maskformer_r50_ytvis19,
               daq_online_r50_ytvis19, daq_offline_r50_ovis):
    cfg = preset()
    model = small(cfg)
    rng = np.random.RandomState(0)
    video = {"images": rng.randn(3, 64, 64, 3).astype(np.float32), "image_size": [64, 64],
             "height": 48, "width": 48, "video_id": 1}
    with tempfile.TemporaryDirectory() as tmp:
        ev = YTVISEvaluator("synthetic", tmp)
        seen = ev.process
        ev.process = lambda vid, out: (containers.append(type(out["pred_masks"]).__name__), seen(vid, out))
        run_vis_inference(cfg, model, iter([video]), ev)
        ev.write_results()
    rows.append(len(ev.predictions))
for preset, run, evaluator in ((dvis_online_r50_vipseg, run_vps_inference, VPSEvaluator),
                               (dvis_online_r50_vspw, run_vss_inference, VSSEvaluator)):
    cfg = preset()
    model = small(cfg)
    video = {"images": np.random.RandomState(1).randn(3, 64, 64, 3).astype(np.float32),
             "image_size": [64, 64], "height": 48, "width": 48, "video_id": "v1",
             "file_names": [f"v1/{t:05d}.jpg" for t in range(3)]}
    with tempfile.TemporaryDirectory() as tmp:
        ev = evaluator("synthetic", tmp)
        run(cfg, model, iter([video]), ev, *([58] if run is run_vps_inference else []))
        res = ev.evaluate()
        pngs = sum(f.endswith(".png") for _, _, fs in os.walk(tmp) for f in fs)
    tasks.append([cfg.test.task, res["videos"], pngs])
# DVIS-DAQ through the VPS loop, MOTS (the DAQ eval loop, UniYTVISEvaluator)
# and the VOS writer on given first-frame objects
cfg = daq_online_r50_ytvis19()
model = small(cfg)
video = {"images": np.random.RandomState(1).randn(3, 64, 64, 3).astype(np.float32),
         "image_size": [64, 64], "height": 48, "width": 48, "video_id": "v1",
         "file_names": [f"v1/{t:05d}.jpg" for t in range(3)]}
with tempfile.TemporaryDirectory() as tmp:
    ev = VPSEvaluator("synthetic", tmp)
    run_vps_inference(cfg, model, iter([video]), ev, 40)
    tasks.append(["daq_vps", ev.evaluate()["videos"],
                  sum(f.endswith(".png") for _, _, fs in os.walk(tmp) for f in fs)])
    cfg.test.task = "mots"
    ev = UniYTVISEvaluator("synthetic", tmp)
    daq_inference.run_daq_inference(cfg, model, iter([dict(video, video_id=1)]), ev)
    tasks.append(["mots", len(ev.predictions), os.path.exists(ev.write_results())])
    cfg.output_dir = tmp
    daq_inference._vos_output(cfg, dict(video, first_frame_masks=np.ones((1, 64, 64), bool),
                                        first_frame_ids=[1]),
                              np.random.RandomState(2).randn(4, 41).astype(np.float32),
                              np.random.RandomState(3).randn(4, 3, 16, 16).astype(np.float16))
    tasks.append(["vos", sum(f.endswith(".png") for f in os.listdir(os.path.join(tmp, "inference", "v1")))])
# open vocabulary: the three presets through run_ov_inference, the RN50
# trunk through the VSS route (random text classifiers over 40 classes)
from dvis_plus_tpu_torch import cli_ov
from dvis_plus_tpu_torch.config import (
    ov_minvis_convnextl_zeroshot_ytvis19, ov_offline_convnextl_zeroshot_ytvis19,
    ov_online_convnextl_zeroshot_ytvis19,
)
from dvis_plus_tpu_torch.engine.ov_inference import ov_video_logits_masks_fn, run_ov_inference

def small_ov(cfg, resnet=False):
    m = cfg.model
    m.compute_dtype = "float32"
    m.pixel_decoder.conv_dim = m.pixel_decoder.mask_dim = 32
    m.pixel_decoder.transformer_enc_layers = 1
    m.pixel_decoder.transformer_dim_feedforward = 64
    m.transformer_decoder.hidden_dim = m.transformer_decoder.mask_dim = 32
    m.transformer_decoder.num_queries = 4
    m.transformer_decoder.nheads = 4
    m.transformer_decoder.dim_feedforward = 64
    m.transformer_decoder.dec_layers = 1
    m.tracker.num_layers = m.refiner.num_layers = 1
    m.tracker.feedforward_dim = m.refiner.feedforward_dim = 64
    cfg.test.window_size = 2
    b = m.backbone
    b.clip_depths, b.clip_dims, b.clip_resnet_width = (1, 1, 1, 1), (8, 16, 24, 32), 8
    if resnet:
        b.name, b.clip_model_type = "clip_rn50", "resnet"
    cfg.model.ov.clip_embed_dim = 16
    torch.manual_seed(0)
    return cli_ov.build_ov_model(cfg).eval()

tc = np.random.RandomState(3).randn(40 * 2, 16).astype(np.float32)
nt, overlap = (2,) * 40 + (1,), (np.arange(40) % 3 == 0).astype(np.float32)
ov_rows = []
for preset in (ov_online_convnextl_zeroshot_ytvis19, ov_minvis_convnextl_zeroshot_ytvis19,
               ov_offline_convnextl_zeroshot_ytvis19):
    cfg = preset()
    model = small_ov(cfg)
    video = {"images": np.random.RandomState(0).randn(4, 64, 64, 3).astype(np.float32),
             "image_size": [64, 64], "height": 48, "width": 48, "video_id": 1}
    with tempfile.TemporaryDirectory() as tmp:
        ev = YTVISEvaluator("synthetic", tmp)
        seen = ev.process
        ev.process = lambda vid, out: (containers.append(type(out["pred_masks"]).__name__), seen(vid, out))
        run_ov_inference(cfg, model, iter([video]), ev, tc, nt, overlap)
    ov_rows.append(len(ev.predictions))
cfg = ov_offline_convnextl_zeroshot_ytvis19()
cfg.test.task = "vss"
model = small_ov(cfg, resnet=True)
with tempfile.TemporaryDirectory() as tmp:
    ev = VSSEvaluator("synthetic", tmp)
    run_vss_inference(cfg, model, iter([dict(video, video_id="v1", file_names=[f"v1/{t:05d}.jpg" for t in range(4)])]),
                      ev, logits_masks_fn=ov_video_logits_masks_fn(cfg, model, tc, nt, overlap))
    tasks.append(["ov_vss", ev.evaluate()["videos"],
                  sum(f.endswith(".png") for _, _, fs in os.walk(tmp) for f in fs)])
small = [
    "model.compute_dtype=float32", "model.backbone.vit_embed_dim=32", "model.backbone.vit_depth=2",
    "model.backbone.vit_num_heads=2", "model.backbone.vit_deform_num_heads=2",
    "model.backbone.vit_interaction_indexes=[[0,0],[1,1]]", "model.backbone.vit_conv_inplane=8",
    "model.pixel_decoder.conv_dim=32", "model.pixel_decoder.mask_dim=32",
    "model.pixel_decoder.transformer_enc_layers=1", "model.pixel_decoder.transformer_dim_feedforward=64",
    "model.transformer_decoder.hidden_dim=32", "model.transformer_decoder.num_queries=4",
    "model.transformer_decoder.nheads=4", "model.transformer_decoder.dim_feedforward=64",
    "model.transformer_decoder.dec_layers=1", "model.transformer_decoder.mask_dim=32",
    "model.transformer_decoder.reid_hidden_dim=32", "model.tracker.num_layers=1",
    "model.tracker.feedforward_dim=64", "model.refiner.num_layers=1",
    "model.refiner.feedforward_dim=64", "input.min_size_test=64", "input.max_size_test=96",
    "test.window_size=2", "test.max_num=3",
]
with tempfile.TemporaryDirectory() as tmp:
    res = cli.main(["--config-file", "configs/dvis/dvis_offline_vitl_ytvis19.yaml", "--eval-only",
                    "--device", "cpu", *small, "output_dir=" + tmp])["ytvis_2019_val"]
    ov_res = cli_ov.main(["--config-file", "configs/ov/ov_offline_convnextl_zeroshot_ytvis19.yaml",
                          "--eval-only", "--device", "cpu", "--random-text", *small,
                          "model.backbone.clip_depths=[1,1,1,1]", "model.backbone.clip_dims=[8,16,24,32]",
                          "model.ov.clip_embed_dim=16", "output_dir=" + tmp])["ytvis_2019_val"]
train = []
for yaml in TRAIN_YAMLS:
    # the COCO pseudo-video YAMLs keep their own clip lengths (1 and 2); a
    # DAQ cutter as many new-instance queries as the segmenter has, its
    # curriculum 2 frames of 3, then all 3
    frames = [] if "coco" in yaml else ["input.sampling_frame_num=2"]
    if yaml.startswith("daq/"):
        frames = ["input.sampling_frame_num=3", "model.daq.num_new_ins=4", "model.daq.max_num_instances=4",
                  "model.daq.num_slots=2", "model.daq.using_frame_num=[2,3]", "model.daq.steps=[1]",
                  "model.daq.increasing_step=[1]"]
    with tempfile.TemporaryDirectory() as tmp:
        trained = cli.main(["--config-file", f"configs/{yaml}.yaml", "--device", "cpu",
                            *small, "solver.max_iter=2", "solver.ims_per_batch=1", *frames,
                            "input.min_size_train=[64]",
                            "input.max_size_train=96", "model.criterion.max_num_instances=4",
                            "model.criterion.train_num_points=64", "output_dir=" + tmp])
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            train.append([yaml, trained["step"], len(f.read().splitlines()),
                          sorted(os.listdir(os.path.join(tmp, "checkpoints")))])
roots = ("jax", "jaxlib", "flax", "optax", "dvis_plus_tpu", "triton")
print(json.dumps({
    "rows": rows,
    "cli": [res["device"], res["predictions"], "AP" in res],
    "ov_rows": ov_rows,
    "ov_cli": [ov_res["device"], ov_res["predictions"], "AP" in ov_res],
    "train": train,
    "loaded": sorted(k for k in sys.modules if k.split(".")[0] in roots),
    "containers": containers,
    "tasks": tasks,
    "built": _build.library.cache_info().currsize,
    "codec": rle.library.cache_info().currsize,
    "launches": [msdeform.launches, swin_window_attn.launches, flash_attn.launches],
}))
"""


def test_port_imports_and_cpu_path_need_no_jax_triton_or_nvcc(tmp_path):
    """No jax, jaxlib, flax, optax, JAX-package or triton module is loaded."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from synth_data import make_coco, make_ytvis

    from dvis_plus_tpu.data.datasets.categories import YTVIS_2019_CLASSES

    make_ytvis(str(tmp_path), "ytvis_2019", YTVIS_2019_CLASSES, n_videos=2, length=3)
    make_coco(str(tmp_path), n_images=2)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", DVIS_DATASETS=str(tmp_path))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    # top-20 rows from each of the six models and 16 from each DAQ model
    # (its sequences padded to 16 rows), their masks downloaded as
    # per-column runs; the CLI scored 2 videos x top-3 on the CPU
    assert out == {"rows": [20] * 6 + [16] * 2, "cli": ["cpu", 6, True], "loaded": [],
                   "ov_rows": [20] * 3, "ov_cli": ["cpu", 6, True],
                   "train": [[yaml, 2, 1, ["step_0000002.pth"]] for yaml in TRAIN_YAMLS],
                   "containers": ["ColRunMasks"] * 11,
                   "tasks": [["vps", 1, 3], ["vss", 1, 3], ["daq_vps", 1, 3], ["mots", 16, True],
                             ["vos", 3], ["ov_vss", 1, 4]],
                   "built": 0, "codec": 1,
                   "launches": [0, 0, 0]}
