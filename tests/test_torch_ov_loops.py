"""The port's open-vocabulary eval loop (``engine/ov_inference.py``) against
the JAX package's (``dvis_plus_tpu/engine/ov_inference.py``) on the tiny
OV models with the same seeded weights, text classifier and seen mask:

- MinVIS OV, DVIS++ online OV and offline OV over a video of two windows
  (T a whole number of windows): the video logits (the mean of the frames'
  fused log-probs) rel <= 1e-5, the top-K labels equal and scores rel <=
  1e-4, the masks rel <= 1e-5 (offline: the fp16 masks both loops keep,
  within one fp16 unit); MinVIS also with its masks paged to the host;
- offline OV where T is not a whole number of windows: the JAX loop pools
  its padded tail frames into the in-vocabulary features, so its logits
  depend on the window size; the port pools the video's own frames, gives
  the same logits at either window size, and equals the JAX loop where no
  window is padded (ROADMAP "Tree state");
- online OV in bf16: rel <= 2e-2 (both packages promote the bf16 class
  embeddings against the fp32 classifier to fp32 logits);
- the OV routes of ``run_vps_inference`` / ``run_vss_inference``
  (``logits_masks_fn=``): the same id maps and segments, the same class
  maps.

Every mask the loops threshold (the decoder's and the tracker's at stride
4, their 8x downsample onto the CLIP map, the refiner's) lies more than 1e-4
from 0 on the JAX side (``margin``)."""
import copy

import numpy as np
import pytest
import torch

from dvis_plus_tpu.engine import inference as jax_inference
from dvis_plus_tpu.engine.ov_inference import ov_video_logits_masks_fn as jax_fn
from dvis_plus_tpu_torch.engine import inference
from dvis_plus_tpu_torch.engine.ov_inference import ov_video_logits_masks_fn
from dvis_plus_tpu_torch.models.meta.minvis import topk_select
from dvis_plus_tpu_torch.models.ov.heads import resize_masks
from tests.test_torch_common import (
    H_IN,
    W_IN,
    jax_ov_model_and_params,
    margin,
    ov_text_classifier,
    rel_err,
)

MARGIN = 1e-4


def video(T, seed=11):
    return np.random.RandomState(seed).randn(T, H_IN, W_IN, 3).astype(np.float32)


def run_both(arch, T, window=3, dtype="float32", seed=11):
    cfg, jm, params, pm = jax_ov_model_and_params("convnext", arch)
    cfg = copy.deepcopy(cfg)
    cfg.test.window_size = window
    cfg.model.compute_dtype = dtype
    tc, nt, overlap = ov_text_classifier()
    x = video(T, seed)
    if dtype != "float32":  # both models built anew for the compute dtype
        from dvis_plus_tpu_torch.cli_ov import build_ov_model

        jm = type(jm)(cfg.model)
        pm2 = build_ov_model(cfg)
        pm2.load_state_dict(pm.state_dict())
        pm = pm2.eval()
    want = jax_fn(cfg, jm, params, tc, nt, overlap)(x)
    with torch.no_grad():
        got = ov_video_logits_masks_fn(cfg, pm, tc, nt, overlap)(x)
    return cfg, [np.array(w, np.float32) for w in want], [g.float().numpy() for g in got]


def assert_topk_equal(got_logits, want_logits, k=10):
    gs, gl, gq = topk_select(torch.from_numpy(got_logits), k)
    ws, wl, wq = topk_select(torch.from_numpy(want_logits), k)
    assert gl.tolist() == wl.tolist() and gq.tolist() == wq.tolist()
    assert np.abs(gs.numpy() - ws.numpy()).max() <= 1e-4 * ws.numpy().max()


@pytest.mark.parametrize("arch", ["minvis_ov", "dvis_online_ov", "dvis_offline_ov"])
def test_loops_equal_jax_at_whole_windows(arch):
    T = 6
    _, (wl, wm), (gl, gm) = run_both(arch, T)
    wm, gm = wm[:, :T], gm[:, :T]
    assert gl.shape == wl.shape == (8, 6) and gm.shape == wm.shape == (8, T, H_IN // 4, W_IN // 4)
    assert margin(wm) > MARGIN
    assert margin(resize_masks(torch.from_numpy(wm), (H_IN // 32, W_IN // 32))) > MARGIN
    assert rel_err(gl, wl) <= 1e-5
    assert_topk_equal(gl, wl)
    if arch == "dvis_offline_ov":  # fp16 in both loops: within one unit
        assert np.abs(gm - wm).max() <= np.abs(wm).max() * 2.0 ** -10
    else:
        assert rel_err(gm, wm) <= 1e-5


def test_minvis_paged_to_host_equals_jax(monkeypatch):
    """A memory budget of ~0 pages every window's masks to host fp16 and
    aligns them there, in both packages."""
    monkeypatch.setenv("DVIS_OFFLINE_MF_BUDGET_GB", "1e-6")
    T = 6
    _, (wl, wm), (gl, gm) = run_both("minvis_ov", T)
    assert rel_err(gl, wl) <= 1e-5
    assert_topk_equal(gl, wl)
    # fp16 on both hosts, gathered by the same permutations: within one unit
    assert np.abs(gm[:, :T] - wm[:, :T]).max() <= np.abs(wm).max() * 2.0 ** -10


def test_offline_padding_of_the_last_window():
    """T = 7 with windows of 3 pads two frames: the JAX loop's in-vocabulary
    logits change with the window (3 against 7, which pads none), the
    port's do not, and the two packages agree at window 7."""
    T = 7
    _, (j3, _), (p3, _) = run_both("dvis_offline_ov", T, window=3)
    _, (j7, _), (p7, _) = run_both("dvis_offline_ov", T, window=7)
    assert rel_err(p3, p7) <= 1e-5
    assert rel_err(p7, j7) <= 1e-5
    assert rel_err(j3, j7) > 1e-5  # the padded frames join the JAX loop's pooling


def test_online_bf16_equals_jax():
    T = 6
    _, (wl, wm), (gl, gm) = run_both("dvis_online_ov", T, dtype="bfloat16")
    assert rel_err(gl, wl) <= 2e-2
    assert rel_err(gm[:, :T], wm[:, :T]) <= 2e-2


class TaskRecorder:
    def __init__(self):
        self.out = {}

    def process(self, video_id, frame_names, maps, segments_infos=None):
        self.out[video_id] = (np.array(maps), segments_infos)


def _task_loader():
    for vid, (T, out) in enumerate([(6, (48, 72)), (3, (96, 144))], 1):
        yield {"images": video(T, seed=30 + vid), "image_size": np.asarray((H_IN, W_IN)),
               "height": out[0], "width": out[1], "video_id": f"video_{vid}",
               "file_names": [f"{t:05d}.jpg" for t in range(T)]}


@pytest.mark.parametrize("task,arch", [("vps", "dvis_online_ov"), ("vss", "dvis_offline_ov")])
def test_ov_task_routes_equal_jax(task, arch):
    cfg, jm, params, pm = jax_ov_model_and_params("convnext", arch)
    cfg = copy.deepcopy(cfg)
    cfg.test.task = task
    cfg.test.overlap_threshold = 0.3
    tc, nt, overlap = ov_text_classifier()
    want, got = TaskRecorder(), TaskRecorder()
    jfn = jax_fn(cfg, jm, params, tc, nt, overlap)
    pfn = ov_video_logits_masks_fn(cfg, pm, tc, nt, overlap)
    if task == "vps":
        jax_inference.run_vps_inference(cfg, jm, params, _task_loader(), want, 2, logits_masks_fn=jfn)
        inference.run_vps_inference(cfg, pm, _task_loader(), got, 2, logits_masks_fn=pfn)
    else:
        jax_inference.run_vss_inference(cfg, jm, params, _task_loader(), want, logits_masks_fn=jfn)
        inference.run_vss_inference(cfg, pm, _task_loader(), got, logits_masks_fn=pfn)
    assert sorted(got.out) == sorted(want.out) == ["video_1", "video_2"]
    for vid, (w_maps, w_infos) in want.out.items():
        g_maps, g_infos = got.out[vid]
        np.testing.assert_array_equal(g_maps, w_maps.astype(g_maps.dtype))
        assert g_infos == w_infos


def test_closed_vocabulary_loops_refuse_an_ov_model():
    cfg, _, _, pm = jax_ov_model_and_params("convnext", "dvis_online_ov")
    with pytest.raises(ValueError, match="cli_ov"):
        inference.run_vis_inference(cfg, pm, iter([]), None)
