"""The offline slice: the port's ``_online_video`` and ``run_vis_inference``
for a tiny Swin DVISOffline against the JAX eval loop on the same weights
(fp32, exact deformable op, JV matcher), the whole-clip ``forward`` and
``refine`` against the JAX module's, and the paging budget's environment
override on both eval loops.

7 frames with window 3: three windows, the last one ragged. The JAX eval loop
buckets the refiner's embed pass to 4 windows (12 frames, replicate-padded
and time-masked); the port runs the true 7, so equal outputs here also show
that the two forms agree. Logits, masks and aux: rel <= 1e-4. With
``DVIS_OFFLINE_MF_BUDGET_GB`` set low both eval loops page the masks to host
fp16; both sides round nearly equal fp32 values to fp16, so there the
masks agree to rel 1e-3 (half an fp16 ulp is 4.9e-4 of a value)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvis_plus_tpu.engine.inference as jax_inference
import dvis_plus_tpu_torch.engine.inference as port_inference
from dvis_plus_tpu.models.meta.minvis import topk_select
from tests.test_torch_common import (
    images,
    jax_model_and_params,
    jax_offline_model_and_params,
    jax_vit_offline_model_and_params,
    nchw,
    port_model,
    rel_err,
)
from tests.test_torch_dvis_online import Recorder, _loader, _record_paged
from tests.test_torch_postproc import _jax_prethreshold

torch.set_num_threads(2)

LOW_BUDGET = "1e-9"  # GB: every video pages to the host


def _to_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("paged", [False, True])
def test_offline_video_matches_jax(monkeypatch, paged):
    if paged:
        monkeypatch.setenv("DVIS_OFFLINE_MF_BUDGET_GB", LOW_BUDGET)
    cfg, model, params = jax_offline_model_and_params()
    x = images(7, seed=21)
    want = jax_inference._online_video(cfg, model, params, x, {}, 3)
    with torch.inference_mode():
        got = port_inference._online_video(cfg, port_model(cfg, params), x, 3)
    (gl, gm, ga), (wl, wm, wa) = got, want
    assert gm.shape == wm[:, :7].shape == (8, 7, 16, 24)
    assert isinstance(wm, np.ndarray) == paged  # the JAX eval loop paged to the host
    assert (gm.device.type, gm.dtype) == (("cpu", torch.float16) if paged else ("cpu", torch.float32))
    assert rel_err(_to_np(gl), wl) <= 1e-4
    assert rel_err(_to_np(ga), wa) <= 1e-4
    assert rel_err(_to_np(gm), _to_np(wm[:, :7])) <= (1e-3 if paged else 1e-4)


def test_whole_clip_forward_and_refine_match_jax():
    """``DVISOffline.forward`` (one clip through segmenter, tracker and
    refiner) and ``refine`` against the JAX ``__call__`` and ``refine``."""
    from dvis_plus_tpu.models.meta.dvis_offline import DVISOffline as JaxDVISOffline

    cfg, model, params = jax_offline_model_and_params()
    x = images(3, seed=23)
    _, w_track, w_ref, _ = jax.jit(model.apply)(params, jnp.asarray(x)[None])
    port = port_model(cfg, params)
    with torch.inference_mode():
        _, g_track, g_ref, _ = port(nchw(x)[None])
    assert rel_err(g_track["pred_logits"], w_track["pred_logits"]) <= 1e-4
    for k in ("pred_logits", "pred_masks", "pred_embds"):
        assert g_ref[k].shape == w_ref[k].shape, k
        assert rel_err(g_ref[k], w_ref[k]) <= 1e-4, k

    rng = np.random.RandomState(24)
    C2, Cm = g_ref["pred_embds"].shape[-1], cfg.model.transformer_decoder.hidden_dim
    inst = rng.randn(1, 4, 8, C2).astype(np.float32)
    frame = rng.randn(1, 4, 8, C2).astype(np.float32)
    mf = rng.randn(1, 4, 16, 24, Cm).astype(np.float32)  # NHWC, the JAX layout
    want = jax.jit(lambda p, *a: model.apply(p, *a, method=JaxDVISOffline.refine))(
        params, jnp.asarray(inst), jnp.asarray(frame), jnp.asarray(mf))
    with torch.inference_mode():
        got = port.refine(torch.from_numpy(inst), torch.from_numpy(frame),
                          torch.from_numpy(np.ascontiguousarray(np.moveaxis(mf, -1, 2))))
    for k in ("pred_logits", "pred_masks"):
        assert rel_err(got[k], want[k]) <= 1e-5, k


def test_online_paging_honours_env_override(monkeypatch):
    """Repair: the online half reads the budget through
    ``eval_mask_budget_bytes``, so the override pages both eval loops."""
    monkeypatch.setenv("DVIS_OFFLINE_MF_BUDGET_GB", LOW_BUDGET)
    cfg, model, params = jax_model_and_params()
    assert port_inference.eval_mask_budget_bytes(cfg) == jax_inference.eval_mask_budget_bytes(cfg)
    x = images(5, seed=22)
    _, wm, _ = jax_inference._online_video(cfg, model, params, x, {}, 3)
    with torch.inference_mode():
        _, gm, _ = port_inference._online_video(cfg, port_model(cfg, params), x, 3)
    assert isinstance(wm, np.ndarray) and wm.dtype == np.float16
    assert gm.dtype == torch.float16 and gm.device.type == "cpu"
    assert rel_err(gm.float().numpy(), wm.astype(np.float32)) <= 1e-3


def test_offline_run_vis_inference_matches_jax(monkeypatch):
    cfg, model, params = jax_offline_model_and_params()
    seen = _record_paged(monkeypatch, jax_inference)
    seen_port = _record_paged(monkeypatch, port_inference)
    want = Recorder()
    jax_inference.run_vis_inference(cfg, model, params, _loader(), want)
    got = Recorder()
    port_inference.run_vis_inference(cfg, port_model(cfg, params), _loader(), got)

    assert sorted(got.rows) == sorted(want.rows) == [1, 2]
    for vid in (1, 2):
        g, w = got.rows[vid], want.rows[vid]
        np.testing.assert_allclose(g["pred_scores"], w["pred_scores"], rtol=1e-4)
        assert g["pred_labels"] == w["pred_labels"]
        assert g["pred_masks"].shape == w["pred_masks"].shape
        mask_cls, mask_pred, img, out, pad, aux = seen[vid]
        for j in (0, 1, 5):  # logits, masks, aux
            assert rel_err(seen_port[vid][j], seen[vid][j]) <= 1e-4
        # JAX pre-threshold masks of its top-K queries (scores fused with aux)
        scores, _, queries = topk_select(mask_cls, len(w["pred_scores"]), aux)
        np.testing.assert_allclose(np.asarray(scores), w["pred_scores"], rtol=1e-6)
        pre = _jax_prethreshold(mask_pred[np.asarray(queries)], img, out, pad)
        for bits in (g["pred_masks"].unpack(), w["pred_masks"].unpack()):
            differ = bits != (pre > 0)
            assert np.all(np.abs(pre[differ]) < 1e-4)


@pytest.mark.parametrize("variant", ["default", "serving"])
def test_offline_vit_video_matches_jax(variant):
    """The ViT-Adapter slice through ``_online_video``: 7 frames, window 3.
    ``serving`` sets ``vit_flash_attention`` and ``vit_extractor_coarse``, the
    two knobs of the JAX package's ViT-L serving set-up (on the CPU the flash
    flag takes the dense path on both sides)."""
    serving = variant == "serving"
    cfg, model, params = jax_vit_offline_model_and_params(coarse=serving, flash=serving)
    x = images(7, seed=25)
    wl, wm, wa = jax_inference._online_video(cfg, model, params, x, {}, 3)
    with torch.inference_mode():
        gl, gm, ga = port_inference._online_video(cfg, port_model(cfg, params), x, 3)
    assert gm.shape == wm[:, :7].shape == (8, 7, 16, 24)
    assert rel_err(_to_np(gl), wl) <= 1e-4
    assert rel_err(_to_np(ga), wa) <= 1e-4
    assert rel_err(_to_np(gm), _to_np(wm[:, :7])) <= 1e-4


def test_offline_vit_run_vis_inference_matches_jax(monkeypatch):
    """The ViT-Adapter slice as a whole, with the bars of the Swin slice:
    logits, masks and aux rel <= 1e-4; rows with equal labels, scores rel
    1e-4, equal mask bits but where |pre-threshold| < 1e-4."""
    cfg, model, params = jax_vit_offline_model_and_params()
    seen = _record_paged(monkeypatch, jax_inference)
    seen_port = _record_paged(monkeypatch, port_inference)
    want = Recorder()
    jax_inference.run_vis_inference(cfg, model, params, _loader(), want)
    got = Recorder()
    port_inference.run_vis_inference(cfg, port_model(cfg, params), _loader(), got)

    assert sorted(got.rows) == sorted(want.rows) == [1, 2]
    for vid in (1, 2):
        g, w = got.rows[vid], want.rows[vid]
        np.testing.assert_allclose(g["pred_scores"], w["pred_scores"], rtol=1e-4)
        assert g["pred_labels"] == w["pred_labels"]
        assert g["pred_masks"].shape == w["pred_masks"].shape
        mask_cls, mask_pred, img, out, pad, aux = seen[vid]
        for j in (0, 1, 5):  # logits, masks, aux
            assert rel_err(seen_port[vid][j], seen[vid][j]) <= 1e-4
        scores, _, queries = topk_select(mask_cls, len(w["pred_scores"]), aux)
        pre = _jax_prethreshold(mask_pred[np.asarray(queries)], img, out, pad)
        for bits in (g["pred_masks"].unpack(), w["pred_masks"].unpack()):
            differ = bits != (pre > 0)
            assert np.all(np.abs(pre[differ]) < 1e-4)
