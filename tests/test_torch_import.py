"""The port imports no jax, flax or JAX-package module, and no triton, and
builds nothing, when every module is imported and its CPU path runs.

Runs in a subprocess: the pytest process itself has jax loaded (conftest)."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, json, pkgutil, sys, tempfile
import numpy as np, torch
torch.set_num_threads(2)
import dvis_plus_tpu_torch
for m in pkgutil.walk_packages(dvis_plus_tpu_torch.__path__, "dvis_plus_tpu_torch."):
    importlib.import_module(m.name)

from dvis_plus_tpu_torch.config import dvis_offline_swinl_ytvis19, dvis_online_r50_ytvis19
from dvis_plus_tpu_torch.engine.inference import run_vis_inference
from dvis_plus_tpu_torch.evaluation.evaluators import YTVISEvaluator
from dvis_plus_tpu_torch.models.meta.dvis_offline import DVISOffline
from dvis_plus_tpu_torch.models.meta.dvis_online import DVISOnline
from dvis_plus_tpu_torch.ops import _build, msdeform, swin_window_attn

rows = []
for preset, arch in ((dvis_online_r50_ytvis19, DVISOnline), (dvis_offline_swinl_ytvis19, DVISOffline)):
    cfg = preset()
    m = cfg.model
    m.compute_dtype = "float32"
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
    cfg.test.window_size = 2
    torch.manual_seed(0)
    model = arch(m).eval()
    rng = np.random.RandomState(0)
    video = {"images": rng.randn(3, 64, 64, 3).astype(np.float32), "image_size": [64, 64],
             "height": 48, "width": 48, "video_id": 1}
    with tempfile.TemporaryDirectory() as tmp:
        ev = YTVISEvaluator("synthetic", tmp)
        run_vis_inference(cfg, model, iter([video]), ev)
        ev.write_results()
    rows.append(len(ev.predictions))
roots = ("jax", "jaxlib", "flax", "dvis_plus_tpu", "triton")
print(json.dumps({
    "rows": rows,
    "loaded": sorted(k for k in sys.modules if k.split(".")[0] in roots),
    "built": _build.library.cache_info().currsize,
    "launches": [msdeform.launches, swin_window_attn.launches],
}))
"""


def test_port_imports_and_cpu_path_need_no_jax_triton_or_nvcc():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    # top-20 rows from the online R50 and the offline Swin model each
    assert out == {"rows": [20, 20], "loaded": [], "built": 0, "launches": [0, 0]}
