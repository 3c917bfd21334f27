"""Shared helpers for the PyTorch port's parity tests (no tests of its own).

Builds tiny DVIS++ online (ResNet-50) and offline (Swin, ViT-Adapter)
configurations and
seeded numpy weights shaped like the JAX model's parameter tree (random
everywhere, so that the reference's zero-initialized projections such as
the sampling offsets give generic sampling locations). The same weights
load into the port through ``dvis_plus_tpu_torch.convert.state_dict_from_jax``.
"""
import functools
import json
import os
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from dvis_plus_tpu.core.config import Config

H_IN, W_IN = 64, 96  # input size of the tiny parity runs


def tiny_cfg(impl: str = "exact", enc_layers: int = 2, tracker_layers: int = 2) -> Config:
    """fp32 parity settings (PARITY.md): exact deformable op or its clamped
    form, exact JV matcher, float32 compute."""
    cfg = Config()
    m = cfg.model
    m.meta_architecture = "dvis_online"
    m.num_classes = 5
    m.compute_dtype = "float32"
    pd = m.pixel_decoder
    pd.conv_dim, pd.mask_dim = 32, 32
    pd.transformer_enc_layers = enc_layers
    pd.transformer_dim_feedforward = 64
    pd.transformer_nheads = 4
    pd.msdeform_impl = impl
    td = m.transformer_decoder
    td.hidden_dim, td.mask_dim = 32, 32
    td.num_queries = 8
    td.nheads = 4
    td.dim_feedforward = 64
    td.dec_layers = 2
    td.reid_branch = True
    td.reid_hidden_dim = 48
    m.tracker.num_layers = tracker_layers
    m.tracker.feedforward_dim = 64
    m.tracker.num_heads = 4
    m.tracker.matcher_solver = "jv"
    cfg.test.window_size = 3
    cfg.test.max_num = 10
    cfg.test.mask_download = "packed"
    cfg.test.eval_pipeline = False
    return cfg


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def random_params(shapes, seed: int = 0, scale: float = 0.05):
    """Seeded numpy weights shaped like a JAX param tree (from
    ``jax.eval_shape(model.init, ...)``): normal(0, scale) leaves, norm
    scales around 1, FrozenBN variances positive, and wider sampling-offset
    projections so deformable samples spread over several pixels."""
    rng = np.random.RandomState(seed)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        x = np.asarray(scale * rng.randn(*tree.shape), np.float32)  # () leaves too
        if path[-1] == "var":
            return np.abs(x) + 0.5
        if path[-1] == "scale":
            return x + 1.0
        if "sampling_offsets" in path and path[-1] == "kernel":
            return x * 10.0
        if path[-1] == "relative_position_bias_table":
            return x * 20.0  # a bias of order 1, so the scores depend on it
        if "vit" in path and path[-1] == "kernel" and path[-2] in ("q_proj", "k_proj"):
            return x * 20.0  # scores of order 1, so the softmax is not flat
        if path[-1] == "gamma":
            return x + 0.5  # LayerScale / injector gates of order 1, not 1e-5
        return x

    return walk(shapes, ())


@functools.cache
def jax_model_and_params(impl: str = "exact", enc_layers: int = 2, tracker_layers: int = 2):
    """(cfg, flax module, seeded numpy params) for the tiny DVISOnline."""
    from dvis_plus_tpu.models.meta.dvis_online import DVISOnline

    cfg = tiny_cfg(impl, enc_layers, tracker_layers)
    model = DVISOnline(cfg.model)
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, 2, H_IN, W_IN, 3), jnp.float32)
    )
    return cfg, model, random_params(shapes)


def tiny_offline_cfg(window: int = 12, backbone: str = "swin_tiny") -> Config:
    """DVIS++ offline with a tiny Swin: embed 32, depths (2, 2, 2, 2), heads
    (1, 2, 4, 8), so Dh = 32 in every stage. The backbone name lies outside
    the named variants, so the ``swin_*`` width fields apply on both sides.
    At 64x96 input the stages see 16x24, 8x12, 4x6 and 2x3 tokens: every
    stage pads, and with window 12 the last three are one padded window."""
    cfg = tiny_cfg()
    m = cfg.model
    m.meta_architecture = "dvis_offline"
    b = m.backbone
    b.name = backbone
    b.swin_embed_dim = 32
    b.swin_depths = (2, 2, 2, 2)
    b.swin_num_heads = (1, 2, 4, 8)
    b.swin_window_size = window
    m.refiner.num_layers = 2
    m.refiner.feedforward_dim = 64
    m.refiner.num_heads = 4
    return cfg


@functools.cache
def jax_offline_model_and_params(window: int = 12):
    """(cfg, flax module, seeded numpy params) for the tiny Swin DVISOffline."""
    from dvis_plus_tpu.models.meta.dvis_offline import DVISOffline

    cfg = tiny_offline_cfg(window)
    model = DVISOffline(cfg.model)
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, 2, H_IN, W_IN, 3), jnp.float32)
    )
    return cfg, model, random_params(shapes)


def tiny_vit_backbone(b, coarse: bool = False, flash: bool = False):
    """Set a backbone config to a tiny ViT-Adapter: embed 32, depth 4, 2
    heads (Dh = 16), one trunk block per interaction, ``conv_inplane`` 8, 2
    deformable heads. At 64x96 input the trunk sees 4x6 tokens, not the 37x37
    pretraining grid, so the position embedding is resampled."""
    b.name = "vit_adapter_dinov2"
    b.vit_embed_dim = 32
    b.vit_depth = 4
    b.vit_num_heads = 2
    b.vit_interaction_indexes = ((0, 0), (1, 1), (2, 2), (3, 3))
    b.vit_conv_inplane = 8
    b.vit_deform_num_heads = 2
    b.vit_extractor_coarse = coarse
    b.vit_flash_attention = flash
    return b


def tiny_vit_offline_cfg(coarse: bool = False, flash: bool = False) -> Config:
    """DVIS++ offline with the tiny ViT-Adapter backbone."""
    cfg = tiny_offline_cfg()
    tiny_vit_backbone(cfg.model.backbone, coarse, flash)
    return cfg


@functools.cache
def jax_vit_offline_model_and_params(coarse: bool = False, flash: bool = False):
    """(cfg, flax module, seeded numpy params) for the tiny ViT DVISOffline."""
    from dvis_plus_tpu.models.meta.dvis_offline import DVISOffline

    cfg = tiny_vit_offline_cfg(coarse, flash)
    model = DVISOffline(cfg.model)
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, 2, H_IN, W_IN, 3), jnp.float32)
    )
    return cfg, model, random_params(shapes, seed=3)


def port_model(cfg, params):
    """The port's DVISOnline / DVISOffline (by ``meta_architecture``) with
    the JAX params loaded (strict)."""
    from dvis_plus_tpu_torch.convert import state_dict_from_jax
    from dvis_plus_tpu_torch.models.meta.dvis_offline import DVISOffline
    from dvis_plus_tpu_torch.models.meta.dvis_online import DVISOnline

    arch = DVISOffline if cfg.model.meta_architecture == "dvis_offline" else DVISOnline
    model = arch(cfg.model)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


def images(T: int, seed: int = 1) -> np.ndarray:
    """(T, H, W, 3) normalized synthetic frames."""
    return np.random.RandomState(seed).randn(T, H_IN, W_IN, 3).astype(np.float32)


def host_canvas(cfg, sample: dict) -> np.ndarray:
    """The float32 canvas the port's eval mapper built on the host before it
    handed over uint8 (and the JAX mapper builds): the valid (h, w) of
    ``sample``'s uint8 canvas normalized in numpy, zero elsewhere."""
    h, w = [int(v) for v in sample["image_size"]]
    mean = np.asarray(cfg.model.pixel_mean, np.float32)
    std = np.asarray(cfg.model.pixel_std, np.float32)
    out = np.zeros(sample["images"].shape, np.float32)
    out[:, :h, :w] = (sample["images"][:, :h, :w].astype(np.float32) - mean) / std
    return out


def on_card_canvas(cfg, sample: dict) -> dict:
    """``sample`` of the port's eval mapper with its uint8 ``images``
    normalized as the eval loops normalize them, by
    ``engine.inference._frames`` (here on the CPU) with the sample's valid
    size: (T, H, W, 3) float32, what the JAX eval mapper hands over."""
    from dvis_plus_tpu_torch.engine.inference import _frames

    assert sample["images"].dtype == np.uint8
    x = _frames(sample["images"], torch.device("cpu"), cfg, sample["image_size"])
    return dict(sample, images=x.permute(0, 2, 3, 1).numpy())


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def tiny_minvis_cfg(arch: str = "minvis") -> Config:
    """MinVIS (or CTVIS, with the ReID branch) at the tiny widths: the bare
    segmenter with the exact JV matcher."""
    cfg = tiny_cfg()
    cfg.model.meta_architecture = arch
    cfg.model.transformer_decoder.reid_branch = arch == "ctvis"
    return cfg


@functools.cache
def jax_minvis_model_and_params(arch: str = "minvis"):
    """(cfg, flax Segmenter, seeded numpy params) for tiny MinVIS / CTVIS."""
    from dvis_plus_tpu.models.segmenter.segmenter import Segmenter

    cfg = tiny_minvis_cfg(arch)
    model = Segmenter(cfg.model)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((2, H_IN, W_IN, 3), jnp.float32))
    return cfg, model, random_params(shapes, seed=5)


@functools.cache
def jax_clip_model_and_params():
    """(cfg, flax VideoMaskFormer, seeded numpy params) at the tiny widths."""
    from dvis_plus_tpu.models.meta.video_maskformer import VideoMaskFormer

    cfg = tiny_minvis_cfg("video_maskformer")
    model = VideoMaskFormer(cfg.model)
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jnp.zeros((1, 2, H_IN, W_IN, 3), jnp.float32)
    )
    return cfg, model, random_params(shapes, seed=6)


def port_arch_model(cfg, params):
    """The port's model for ``cfg.model.meta_architecture`` (the CLI's
    ``build_model``) with the JAX params loaded (strict)."""
    from dvis_plus_tpu_torch.cli import build_model
    from dvis_plus_tpu_torch.convert import state_dict_from_jax

    model = build_model(cfg.model)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


# The CLIs end to end: ``train_net_video.py --eval-only`` and the port's
# ``python -m dvis_plus_tpu_torch.cli --eval-only --device cpu`` on a
# synthetic set, the same seeded weights on both sides (an orbax checkpoint
# of the JAX tree for the JAX CLI, its conversion as ``.npz`` for the port).
# YouTube-VIS: two videos of 8 frames at 64x96, resized to 48x72 and padded
# back to 64x96; window 4, so MinVIS aligns across two windows and the JAX
# loop's clip bucket holds exactly the 8 frames.
E2E_TINY = [
    "model.compute_dtype=float32",
    "model.pixel_decoder.conv_dim=32", "model.pixel_decoder.mask_dim=32",
    "model.pixel_decoder.transformer_enc_layers=1",
    "model.pixel_decoder.transformer_dim_feedforward=64",
    "model.transformer_decoder.hidden_dim=32", "model.transformer_decoder.num_queries=8",
    "model.transformer_decoder.nheads=4", "model.transformer_decoder.dim_feedforward=64",
    "model.transformer_decoder.dec_layers=2", "model.transformer_decoder.mask_dim=32",
    "model.transformer_decoder.reid_hidden_dim=32",
    "input.min_size_test=48", "input.max_size_test=80",
    "test.window_size=4", "test.max_num=5",
]
E2E_SETTINGS = {"defaults": [], "packed_plain": ["test.mask_download=packed",
                                                "test.eval_pipeline=false"]}


def _scaled(tree, scales, path=()):
    if isinstance(tree, dict):
        return {k: _scaled(v, scales, path + (k,)) for k, v in tree.items()}
    return tree * np.prod([m for name, m in scales.items() if name in path], dtype=np.float32)


def e2e_weights(yaml: str, root: str, opts=(), tag: str = "model", scales=None):
    """Seeded random weights for the tiny model of ``yaml`` with ``opts``
    (the configuration the CLIs load): (orbax checkpoint directory, ``.npz``
    state dict), written under ``root`` as ``<tag>_orbax`` and ``<tag>.npz``.
    ``scales`` ({module name: factor}) multiplies every leaf under a module
    of that name, e.g. to give the masks and classes more contrast."""
    import orbax.checkpoint as ocp

    from dvis_plus_tpu.core.config import load_config
    from dvis_plus_tpu_torch.convert import state_dict_from_jax
    from train_net_video import build_model

    cfg = load_config(yaml, list(opts))
    model = build_model(cfg)
    x = jnp.zeros((2, H_IN, W_IN, 3), jnp.float32)  # per-frame models: frames; the rest: one clip
    arch = cfg.model.meta_architecture
    if arch.startswith("daq_"):  # the DAQ init traces its training forward: frames, targets, a key
        from dvis_plus_tpu.losses.targets import VideoTargets

        N = cfg.model.criterion.max_num_instances
        targets = VideoTargets(
            labels=jnp.zeros((N,), jnp.int32), masks=jnp.zeros((N, 2, H_IN // 4, W_IN // 4), bool),
            valid=jnp.zeros((N,), bool).at[0].set(True),
            frame_valid=jnp.zeros((N, 2), bool).at[0].set(True))
        shapes = jax.eval_shape(model.init, jax.random.key(0), x, targets, jax.random.key(1))
    else:
        shapes = jax.eval_shape(model.init, jax.random.key(0),
                                x if arch in ("minvis", "ctvis") else x[None])
    params = {"params": _scaled(random_params(shapes["params"], seed=11), scales or {})}
    ckpt = os.path.join(root, f"{tag}_orbax")
    ocp.PyTreeCheckpointer().save(ckpt, params)
    npz = os.path.join(root, f"{tag}.npz")
    np.savez(npz, **{k: v.numpy() for k, v in state_dict_from_jax(params).items()})
    return ckpt, npz


def e2e_run(yaml: str, dataset: str, data: str, tmp: str, opts, tag: str, weights_tag: str = None,
            scales=None):
    """Both CLIs on ``yaml`` with ``opts`` and ``datasets.test=[<dataset>]``
    over the synthetic root ``data``, the same weights (made once under
    ``tmp`` as ``weights_tag``, default ``tag``, with ``scales`` as in
    :func:`e2e_weights`). Returns (the port's result
    dict for the set, the JAX CLI's printed one, the port's output directory
    for the set, the JAX CLI's)."""
    return e2e_start(yaml, dataset, data, tmp, opts, tag, weights_tag, scales)()


def e2e_start(yaml: str, dataset: str, data: str, tmp: str, opts, tag: str, weights_tag: str = None,
              scales=None):
    """:func:`e2e_run` in two halves: this makes the weights and starts the
    JAX CLI in a subprocess; the function it returns runs the port's CLI,
    waits for the JAX CLI and returns what :func:`e2e_run` does. Several
    runs may be started before the first is finished."""
    import json
    import subprocess

    from dvis_plus_tpu_torch import cli

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    opts = [*opts, f"datasets.test=[{dataset}]"]
    weights_tag = weights_tag or tag
    ckpt, npz = os.path.join(tmp, f"{weights_tag}_orbax"), os.path.join(tmp, f"{weights_tag}.npz")
    if not os.path.exists(npz):
        e2e_weights(yaml, tmp, opts, weights_tag, scales)
    env = dict(os.environ, DVIS_DATASETS=data, JAX_PLATFORMS="cpu", PYTHONPATH=repo,
               DVIS_COMPILE_CACHE_DIR=os.path.join(tmp, "jax_cache"))
    env.pop("XLA_FLAGS", None)
    jax_out = os.path.join(tmp, f"jax_{tag}")
    proc = subprocess.Popen(
        [sys.executable, "train_net_video.py", "--config-file", yaml, "--eval-only", *opts,
         f"weights={ckpt}", f"output_dir={jax_out}"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish():
        port_out = os.path.join(tmp, f"port_{tag}")
        old = os.environ.get("DVIS_DATASETS")
        os.environ["DVIS_DATASETS"] = data
        try:
            got = cli.main(["--config-file", yaml, "--eval-only", "--device", "cpu", *opts,
                            f"weights={npz}", f"output_dir={port_out}"])[dataset]
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()  # no-op once it has ended
            if old is None:
                del os.environ["DVIS_DATASETS"]
            else:
                os.environ["DVIS_DATASETS"] = old
        assert proc.returncode == 0, stderr[-3000:]
        want = json.loads(stdout[stdout.index("{\n"):])[dataset]  # the results it prints last
        return (got, want, os.path.join(port_out, "inference", dataset),
                os.path.join(jax_out, "inference", dataset))

    return finish


def e2e_rows(arch: str, tmp: str, setting: str):
    """results.json rows of the JAX CLI and of the port's CLI for ``arch``
    on ``configs/dvis/<arch>_r50_ytvis19.yaml`` under ``setting`` (a key of
    ``E2E_SETTINGS``). ``tmp`` may be shared by the settings of one
    architecture: the data set, the weights and the JAX compile cache are
    made once there."""
    import json

    from dvis_plus_tpu.data.datasets.categories import YTVIS_2019_CLASSES

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, "tools"))
    from synth_data import make_ytvis

    data = os.path.join(tmp, "data")
    if not os.path.isdir(data):
        make_ytvis(data, "ytvis_2019", YTVIS_2019_CLASSES, n_videos=2, length=8)
    _, _, port_dir, jax_dir = e2e_run(f"configs/dvis/{arch}_r50_ytvis19.yaml", "ytvis_2019_val",
                                      data, tmp, E2E_TINY + E2E_SETTINGS[setting], setting, arch)
    with open(os.path.join(port_dir, "results.json")) as f:
        got = json.load(f)
    with open(os.path.join(jax_dir, "results.json")) as f:
        want = json.load(f)
    return got, want


def assert_rows_equal(got, want, score_rtol: float = 1e-4, max_pixels: int = 0):
    """Row for row: video ids, categories and RLE strings equal, scores
    within ``score_rtol``. ``max_pixels`` > 0 lets the decoded masks of a
    frame differ in at most that many pixels (and returns how many differ
    in all) instead of asking for equal RLE strings."""
    from dvis_plus_tpu_torch.utils import rle_numpy

    assert len(got) == len(want) > 0
    flips = 0
    for g, w in zip(got, want):
        assert (g["video_id"], g["category_id"]) == (w["video_id"], w["category_id"])
        assert abs(g["score"] - w["score"]) <= score_rtol * abs(w["score"])
        if not max_pixels:
            assert g["segmentations"] == w["segmentations"]
            continue
        assert len(g["segmentations"]) == len(w["segmentations"])
        for a, b in zip(g["segmentations"], w["segmentations"]):
            if a == b:
                continue
            dec = [np.zeros(0, bool) if s is None else rle_numpy.decode(s).astype(bool) for s in (a, b)]
            if None in (a, b):  # one side empty: the other's pixels are the difference
                n = int(max(m.sum() for m in dec))
            else:
                n = int((dec[0] != dec[1]).sum())
            assert n <= max_pixels, n
            flips += n
    return flips


# DVIS-DAQ: a cutter of 2 layers with a table of 6 slots (2 background slots,
# 8 new-instance queries, kick-out after 2 missed frames, sequences shorter
# than 3 frames dropped as noise); no ReID branch (with it neither package
# can build a DAQ model); class heads x8, mask heads x5 a layer
DAQ_TINY = E2E_TINY + [
    "model.transformer_decoder.reid_branch=false",
    "model.tracker.num_layers=2", "model.tracker.feedforward_dim=64", "model.tracker.num_heads=4",
    "model.refiner.num_layers=1", "model.refiner.feedforward_dim=64",
    "model.daq.max_num_instances=6", "model.daq.num_new_ins=8", "model.daq.num_slots=2",
    "model.daq.kick_out_frame_num=2", "model.daq.noise_frame_num=3",
    # the JAX model's init traces its training forward: keep it small
    "model.criterion.max_num_instances=4", "model.criterion.train_num_points=64",
    "input.sampling_frame_num=2", "input.min_size_train=[64]", "input.max_size_train=96",
]
DAQ_SCALES = {"class_embed": 8.0, "mask_embed": 5.0}
# the DAQ CLIs' masks may differ in this many pixels in a run: both
# packages round the mask logits to fp16 before the upsampling
# (tests/test_torch_e2e_daq.py says why that can move a pixel)
DAQ_FLIP_PIXELS = 2


def e2e_daq_runs(tmp: str, data: str, runs: dict):
    """Start every JAX CLI of ``runs``, then run the port's CLI of each and
    wait for its JAX twin: {tag: what ``e2e_run`` returns}."""
    finish = {tag: e2e_start(yaml, dataset, data, tmp, DAQ_TINY + extra, tag, scales=DAQ_SCALES)
              for tag, (yaml, dataset, extra) in runs.items()}
    return {tag: f() for tag, f in finish.items()}


def e2e_results_rows(run):
    """results.json rows of the port's CLI and of the JAX CLI of one run."""
    _, _, port_dir, jax_dir = run
    with open(os.path.join(port_dir, "results.json")) as f:
        got = json.load(f)
    with open(os.path.join(jax_dir, "results.json")) as f:
        want = json.load(f)
    return got, want


DAQ_K, DAQ_FQ, DAQ_QC, DAQ_NS, DAQ_C = 5, 8, 6, 2, 32  # the tiny DAQ's sizes


def tiny_daq_cfg(arch: str = "daq_online") -> Config:
    """DVIS-DAQ at the tiny widths, fp32: a 2-layer cutter with a table of
    6 slots, 2 background slots and 8 new-instance queries (the segmenter's
    query count), the slot branch gating survival, kick-out after 2 missed
    frames, sequences shorter than 3 frames dropped as noise; window 4."""
    cfg = Config()
    m = cfg.model
    m.meta_architecture = arch
    m.num_classes = DAQ_K
    m.compute_dtype = "float32"
    pd = m.pixel_decoder
    pd.conv_dim = pd.mask_dim = 32
    pd.transformer_enc_layers = 1
    pd.transformer_dim_feedforward = 64
    pd.transformer_nheads = 4
    td = m.transformer_decoder
    td.hidden_dim = td.mask_dim = DAQ_C
    td.num_queries = DAQ_FQ
    td.nheads = 4
    td.dim_feedforward = 64
    td.dec_layers = 2
    m.tracker.num_layers = m.refiner.num_layers = 2
    m.tracker.feedforward_dim = m.refiner.feedforward_dim = 64
    m.tracker.num_heads = m.refiner.num_heads = 4
    d = m.daq
    d.num_new_ins, d.num_slots, d.max_num_instances = DAQ_FQ, DAQ_NS, DAQ_QC
    d.kick_out_frame_num, d.noise_frame_num = 2, 3
    d.ovis_infer = True  # the slot branch gates survival, as in the R50 YAMLs
    d.offline_topk_num = 20
    m.criterion.max_num_instances = 4
    m.criterion.train_num_points = 64
    cfg.test.window_size = 4
    cfg.test.max_num = 5
    return cfg


@functools.cache
def jax_daq_model_and_params(arch: str = "daq_online"):
    """(cfg, JAX DAQOnline or DAQOffline, seeded numpy params, the port's
    model with them). The cutter's class head is scaled x8 (some queries
    pass the selection threshold, some do not), both mask heads x10 a layer
    (mask logits of a trained model's order)."""
    from dvis_plus_tpu.losses.targets import VideoTargets
    from dvis_plus_tpu.models.meta.daq import DAQOffline as JaxOffline
    from dvis_plus_tpu.models.meta.daq import DAQOnline as JaxOnline
    from dvis_plus_tpu_torch.cli import build_model
    from dvis_plus_tpu_torch.convert import state_dict_from_jax

    cfg = tiny_daq_cfg(arch)
    jm = (JaxOffline if arch == "daq_offline" else JaxOnline)(cfg.model)
    N = cfg.model.criterion.max_num_instances
    targets = VideoTargets(
        labels=jnp.zeros((N,), jnp.int32), masks=jnp.zeros((N, 2, H_IN // 4, W_IN // 4), bool),
        valid=jnp.zeros((N,), bool).at[0].set(True), frame_valid=jnp.zeros((N, 2), bool).at[0].set(True))
    x = jnp.zeros((2, H_IN, W_IN, 3), jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), x, targets, jax.random.key(1))
    params = random_params(shapes, seed=3)
    online = params["params"].get("online", params["params"])
    online["cutter"]["class_embed"] = {k: v * 8.0 for k, v in online["cutter"]["class_embed"].items()}
    for head in (online["cutter"]["mask_embed"], online["segmenter"]["transformer_decoder"]["mask_embed"]):
        for layer in head.values():
            layer["kernel"] = layer["kernel"] * 10.0
    pm = build_model(cfg.model)
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    return cfg, jm, params, pm.eval()


# Open vocabulary: ConvNeXt depths (1, 1, 2, 1) at widths (16, 24, 32, 40),
# or a ModifiedResNet of width 8 (res5 = 256 channels: 4 attention-pool heads
# of 64, a 3x3 positional table), CLIP embedding 24, 5 classes x 3 templates
OV_K, OV_R, OV_CC = 5, 3, 24
OV_NT = (OV_R,) * OV_K + (1,)


def tiny_ov_cfg(kind: str = "convnext", arch: str = "dvis_online_ov") -> Config:
    """An open-vocabulary model at the tiny widths of :func:`tiny_cfg`
    (without the ReID branch, which no OV model has), fp32, window 3, and
    the default ``auction`` matcher: in a fresh process the JAX package's
    jitted OV window with the in-graph JV solver fails to run ("Execution
    supplied N buffers but compiled program expected M", jax 0.9.0; ROADMAP
    "Tree state"), and the two packages' auctions agree."""
    cfg = tiny_cfg()
    m = cfg.model
    m.meta_architecture = arch
    m.tracker.matcher_solver = "auction"
    m.num_classes = OV_K
    m.transformer_decoder.reid_branch = False
    m.ov.enabled = True
    m.ov.clip_embed_dim = OV_CC
    b = m.backbone
    if kind == "resnet":
        b.name, b.clip_model_type = "clip_rn50", "resnet"
        b.clip_depths, b.clip_resnet_width, b.clip_attnpool_spacial = (1, 1, 2, 1), 8, 3
    else:
        b.name, b.clip_depths, b.clip_dims = "clip_convnext_l", (1, 1, 2, 1), (16, 24, 32, 40)
    m.refiner.num_layers = 2
    m.refiner.feedforward_dim = 64
    m.refiner.num_heads = 4
    return cfg


def ov_text_classifier(seed: int = 0):
    """(text classifier (K·R, Cc) float32 without the void row, num_templates,
    category overlap (K,): classes 0 and 2 seen)."""
    tc = np.random.RandomState(seed).randn(OV_K * OV_R, OV_CC).astype(np.float32)
    return tc, OV_NT, np.array([1, 0, 1, 0, 0], np.float32)


def _scale_kernels(tree, factor):
    return {k: _scale_kernels(v, factor) if isinstance(v, dict) else (v * factor if k == "kernel" else v)
            for k, v in tree.items()}


@functools.cache
def jax_ov_model_and_params(kind: str = "convnext", arch: str = "dvis_online_ov", seed: int = 3):
    """(cfg, JAX OVSegmenter / DVISOnlineOV / DVISOfflineOV, seeded numpy
    params, the port's model with them). The mask heads are scaled x10 a
    layer (below). The RN50 trunk's conv kernels are
    scaled x3: at width 8 the random convolutions leave the ReLU maps nearly
    constant over the 2x3 stride-32 positions, where the pixel decoder's
    one-channel GroupNorm groups amplify rounding (the JAX model moves 5e-5
    under a 1e-7 perturbation of its features)."""
    from dvis_plus_tpu.models.meta.ov import DVISOfflineOV, DVISOnlineOV, OVSegmenter
    from dvis_plus_tpu_torch.cli_ov import build_ov_model
    from dvis_plus_tpu_torch.convert import state_dict_from_jax

    cfg = tiny_ov_cfg(kind, arch)
    jm = {"minvis_ov": OVSegmenter, "dvis_online_ov": DVISOnlineOV,
          "dvis_offline_ov": DVISOfflineOV}[arch](cfg.model)
    tc, nt, _ = ov_text_classifier()
    x = jnp.zeros((2, H_IN, W_IN, 3)) if arch == "minvis_ov" else jnp.zeros((1, 2, H_IN, W_IN, 3))
    shapes = jax.eval_shape(lambda r, x, t: jm.init(r, x, t, nt), jax.random.key(0), x, jnp.asarray(tc))
    params = random_params(shapes, seed=seed)
    online = params["params"].get("online", params["params"])
    seg = online.get("segmenter", online)
    if kind == "resnet":
        seg["backbone"]["trunk"] = _scale_kernels(seg["backbone"]["trunk"], 3.0)
    # mask heads x10 a layer: mask logits of a trained model's order, so that
    # few lie within 1e-4 of the threshold
    for owner in (seg["transformer_decoder"], online.get("tracker"), params["params"].get("refiner")):
        if owner is not None:
            owner["mask_embed"] = _scale_kernels(owner["mask_embed"], 10.0)
    pm = build_ov_model(cfg)
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    return cfg, jm, params, pm.eval()


def margin(x) -> float:
    """Least |value| of a thresholded (> 0) tensor: above 1e-4 the two
    packages' binary masks cannot differ by rounding."""
    return float(np.abs(np.asarray(x, np.float64)).min())


def open_clip_text_state_dict(prefix: str = "", seed: int = 7, vocab: int = 100, context: int = 16):
    """A seeded open_clip text tower in its own names (``prefix`` ``text.``
    for the CustomTextCLIP layout), numpy float32: ``vocab`` tokens,
    ``context`` positions, width 64 (one 64-channel head), 2 layers,
    projection to ``OV_CC``; with a visual key and ``logit_scale``, which
    the loaders skip."""
    rng = np.random.RandomState(seed)
    W, V, L = 64, vocab, context

    def r(*shape, s=0.1):
        return (s * rng.randn(*shape)).astype(np.float32)

    sd = {"token_embedding.weight": r(V, W, s=0.5), "positional_embedding": r(L, W),
          "ln_final.weight": 1 + r(W), "ln_final.bias": r(W), "text_projection": r(W, OV_CC, s=0.2)}
    for i in range(2):
        pre = f"transformer.resblocks.{i}"
        sd.update({f"{pre}.ln_1.weight": 1 + r(W), f"{pre}.ln_1.bias": r(W),
                   f"{pre}.attn.in_proj_weight": r(3 * W, W, s=0.3), f"{pre}.attn.in_proj_bias": r(3 * W),
                   f"{pre}.attn.out_proj.weight": r(W, W), f"{pre}.attn.out_proj.bias": r(W),
                   f"{pre}.ln_2.weight": 1 + r(W), f"{pre}.ln_2.bias": r(W),
                   f"{pre}.mlp.c_fc.weight": r(4 * W, W), f"{pre}.mlp.c_fc.bias": r(4 * W),
                   f"{pre}.mlp.c_proj.weight": r(W, 4 * W), f"{pre}.mlp.c_proj.bias": r(W)})
    sd = {prefix + k: v for k, v in sd.items()}
    sd["visual.proj"] = r(8, 8)
    sd["logit_scale"] = np.float32(4.6)
    return sd


# Training: the JAX package's random draws, answered to the port by site.
# The port draws every random number of a training step through an object
# with ``uniform`` / ``permutation`` / ``randint`` that take a site name
# (``dvis_plus_tpu_torch/utils/draws.py``); ``JaxDraws`` answers each site with
# what the JAX function draws there, derived from its own key tree below.


class JaxDraws:
    """The port's draws object, answering from a table site -> numpy array;
    a site asked for twice gets the same array, a site not in the table
    fails."""

    def __init__(self, table=None):
        self.table = dict(table or {})

    def _get(self, site, shape):
        a = self.table[site]
        assert tuple(a.shape) == tuple(shape), (site, a.shape, shape)
        return torch.from_numpy(np.array(a))

    def uniform(self, site, shape):
        return self._get(site, shape).float()

    def permutation(self, site, batch, n):
        return self._get(site, (batch, n)).long()

    def randint(self, site, low, high, shape):
        return self._get(site, shape).long()


def jax_uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))


def clip_match_coords(key, B, P):
    """``video_hungarian_match``'s point sets (B, P, 2)."""
    return np.stack([jax_uniform(k, (P, 2)) for k in jax.random.split(key, B)])


def consistent_match_coords(key, B, T, P):
    """``consistent_match``'s point sets (B, T, P, 2)."""
    return np.stack([np.stack([jax_uniform(kf, (P, 2)) for kf in jax.random.split(kb, T)])
                     for kb in jax.random.split(key, B)])


def loss_points(key, R, ccfg):
    """``loss_masks``' candidate and fill points (``uncertain_point_coords_
    with_randomness``' two uniform draws)."""
    k1, k2 = jax.random.split(key)
    n_over = int(ccfg.num_points * ccfg.oversample_ratio)
    n_fill = ccfg.num_points - int(ccfg.importance_sample_ratio * ccfg.num_points)
    return jax_uniform(k1, (R, n_over, 2)), jax_uniform(k2, (R, n_fill, 2))


def add_points(table, layer, key, R, ccfg):
    table[("points", layer, "over")], table[("points", layer, "fill")] = loss_points(key, R, ccfg)


def online_loss_draws(key, B, N, T, n_aux, ccfg):
    """The draws of ``dvis_online_train_loss(key, ...)``: the final layer's
    match points from rng_m (guided and self alike), auxiliary layer i's from
    split(rng_m)[i], the loss points from split(rng_l)."""
    rng_m, rng_l = jax.random.split(key)
    P = ccfg.num_points
    table = {("match", "final"): consistent_match_coords(rng_m, B, T, P)}
    for i, k in enumerate(jax.random.split(rng_m, n_aux + 1)[:n_aux]):
        table[("match", i)] = consistent_match_coords(k, B, T, P)
    lkeys = jax.random.split(rng_l, n_aux + 1)
    add_points(table, "final", lkeys[0], B * N * T, ccfg)
    for i in range(n_aux):
        add_points(table, i, lkeys[1 + i], B * N * T, ccfg)
    return table


def noise_draws(key, T, B, Q, C, mode):
    """The tracker noiser's draws under the model key ``key``: frame t's
    batch row b noises with split(split(key, T)[t], B)[b]."""
    table = {}
    for t, kt in enumerate(jax.random.split(key, T)):
        rows = {"gate": [], "perm": [], "weight": [], "split": []}
        for kb in jax.random.split(kt, B):
            k1, k2 = jax.random.split(kb)
            rows["gate"].append(jax_uniform(k1, ()))
            if mode == "rs":
                rows["perm"].append(np.asarray(jax.random.permutation(k2, Q)))
            elif mode == "wa":
                ka, kw = jax.random.split(k2)
                rows["perm"].append(np.asarray(jax.random.permutation(ka, Q)))
                rows["weight"].append(jax_uniform(kw, (Q, 1)))
            elif mode == "cc":
                ks, kp = jax.random.split(k2)
                rows["split"].append(np.asarray(jax.random.randint(ks, (Q, 1), 0, C)))
                rows["perm"].append(np.asarray(jax.random.permutation(kp, Q)))
        for name, vals in rows.items():
            if vals:
                table[("noise", t, name)] = np.stack(vals)
    return table
