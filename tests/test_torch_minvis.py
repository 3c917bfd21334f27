"""MinVIS and CTVIS: the port's query alignment, its eval loop and the
slice as a whole against the JAX package's, on the same seeded weights
(fp32, exact deformable op).

- ``match_from_embds``, ``minvis_alignment``, ``minvis_post_processing``,
  ``inference_video``: equal permutations, logits rel <= 1e-5, with and
  without ``valid`` (the JAX eval loop's padded frames); ``auction`` equal to
  the JAX auction on well-separated costs.
- the segmenter forward (per frame), per output: rel <= 1e-5.
- ``_minvis_video``, 7 frames in windows of 3: the port runs the true 7
  frames, the JAX eval loop pads the alignment to 12 (its power-of-two window
  bucket, replicate-padded, ``valid``-masked). Logits and aligned masks rel
  <= 1e-4 on the device branch; on the host-paged branch
  (``DVIS_OFFLINE_MF_BUDGET_GB``) both sides round the masks to fp16, so
  there they agree to rel 1e-3 (half an fp16 ulp is 4.9e-4 of a value).
- ``run_vis_inference``: top-K scores rel 1e-4, labels equal, mask bits
  equal but where the JAX pre-threshold value is within 1e-4 of 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvis_plus_tpu.engine.inference as jax_inference
import dvis_plus_tpu.models.meta.minvis as jax_minvis
import dvis_plus_tpu_torch.engine.inference as port_inference
from dvis_plus_tpu_torch.models.meta import minvis
from tests.test_torch_common import (
    images,
    jax_minvis_model_and_params,
    nchw,
    port_arch_model,
    rel_err,
)
from tests.test_torch_dvis_online import Recorder, _loader, _record_paged
from tests.test_torch_postproc import _jax_prethreshold

torch.set_num_threads(2)

LOW_BUDGET = "1e-9"  # GB: every video pages to the host


def _embeds(seed, T=6, Q=8, C=16):
    """Frames whose queries are a noisy permutation of frame 0's: the
    alignment has real permutations to find."""
    rng = np.random.RandomState(seed)
    base = rng.randn(Q, C).astype(np.float32)
    out = []
    for _ in range(T):
        out.append(base[rng.permutation(Q)] + 0.3 * rng.randn(Q, C).astype(np.float32))
    return np.stack(out), rng.randn(T, Q, 5).astype(np.float32)


@pytest.mark.parametrize("solver", ["jv", "auction"])
def test_match_from_embds_matches_jax(solver):
    """Well-separated costs (a permutation of the targets plus small noise),
    so the approximate solver must find the optimum too."""
    rng = np.random.RandomState(1)
    tgt = rng.randn(12, 24).astype(np.float32)
    perm = rng.permutation(12)
    cur = tgt[perm] + 0.05 * rng.randn(12, 24).astype(np.float32)
    got = minvis.match_from_embds(torch.from_numpy(tgt), torch.from_numpy(cur), solver)
    want = jax_minvis.match_from_embds(jnp.asarray(tgt), jnp.asarray(cur), solver)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(perm[got.numpy()], np.arange(12))  # undoes the shuffle


@pytest.mark.parametrize("valid", [False, True])
def test_minvis_alignment_matches_jax(valid):
    embds, logits = _embeds(2)
    v = np.arange(6) < 4 if valid else None
    got_l, got_p = minvis.minvis_alignment(
        torch.from_numpy(logits), torch.from_numpy(embds),
        None if v is None else torch.from_numpy(v), solver="jv")
    want_l, want_p = jax_minvis.minvis_alignment(
        jnp.asarray(logits), jnp.asarray(embds), None if v is None else jnp.asarray(v), solver="jv")
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert (got_p.numpy() != np.arange(8)).any()  # real permutations
    assert rel_err(got_l, want_l) <= 1e-5


@pytest.mark.parametrize("valid", [False, True])
def test_minvis_post_processing_matches_jax(valid):
    embds, logits = _embeds(3)
    masks = np.random.RandomState(4).randn(6, 8, 5, 7).astype(np.float32)
    v = np.arange(6) < 5 if valid else None
    got_l, got_m = minvis.minvis_post_processing(
        torch.from_numpy(logits), torch.from_numpy(masks), torch.from_numpy(embds),
        None if v is None else torch.from_numpy(v), solver="jv")
    want_l, want_m = jax_minvis.minvis_post_processing(
        jnp.asarray(logits), jnp.asarray(masks), jnp.asarray(embds),
        None if v is None else jnp.asarray(v), solver="jv")
    assert got_m.shape == (8, 6, 5, 7)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))  # a gather: exact
    assert rel_err(got_l, want_l) <= 1e-5


def test_inference_video_matches_jax():
    rng = np.random.RandomState(5)
    logits = rng.randn(10, 4).astype(np.float32)
    masks = rng.randn(10, 3, 16, 16).astype(np.float32)
    sizes = ((48, 64), (30, 100), (64, 64))
    got = minvis.inference_video(torch.from_numpy(logits), torch.from_numpy(masks), *sizes, topk=6)
    want = jax_minvis.inference_video(jnp.asarray(logits), jnp.asarray(masks), *sizes, topk=6)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    _, _, jq = jax_minvis.topk_select(jnp.asarray(logits), 6)
    pre = _jax_prethreshold(masks[np.asarray(jq)], *sizes)
    differ = got.masks.numpy() != (pre > 0)
    assert np.all(np.abs(pre[differ]) < 1e-4)


@pytest.mark.parametrize("arch", ["minvis", "ctvis"])
def test_segmenter_forward_matches_jax(arch):
    cfg, model, params = jax_minvis_model_and_params(arch)
    x = images(3, seed=30)
    want = jax.jit(model.apply)(params, jnp.asarray(x))
    with torch.inference_mode():
        got = port_arch_model(cfg, params)(nchw(x))
    for k in ("pred_logits", "pred_masks", "pred_embds"):
        assert got[k].shape == want[k].shape, k
        assert rel_err(got[k], want[k]) <= 1e-5, k
    C = cfg.model.transformer_decoder.hidden_dim
    assert got["pred_embds"].shape[-1] == (2 * C if arch == "ctvis" else C)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["minvis", "ctvis"])
def test_minvis_video_matches_jax(monkeypatch, arch, paged):
    if paged:
        monkeypatch.setenv("DVIS_OFFLINE_MF_BUDGET_GB", LOW_BUDGET)
    cfg, model, params = jax_minvis_model_and_params(arch)
    x = images(7, seed=31)
    wl, wm, _ = jax_inference._minvis_video(cfg, model, params, x, {}, 3)
    with torch.inference_mode():
        gl, gm, aux = port_inference._minvis_video(cfg, port_arch_model(cfg, params), x, 3)
    assert aux is None and gm.shape == (8, 7, 16, 24)
    assert isinstance(wm, np.ndarray) == paged  # the JAX eval loop paged to the host too
    assert (gm.device.type, gm.dtype) == ("cpu", torch.float16 if paged else torch.float32)
    assert rel_err(gl, wl) <= 1e-4
    assert rel_err(gm.float(), np.asarray(wm, np.float32)[:, :7]) <= (1e-3 if paged else 1e-4)


@pytest.mark.parametrize("arch", ["minvis", "ctvis"])
def test_run_vis_inference_matches_jax(monkeypatch, arch):
    """Two videos (7 and 4 frames, window 3) through both eval loops with
    the packed download and the plain loop (``tiny_cfg``'s settings)."""
    cfg, model, params = jax_minvis_model_and_params(arch)
    seen = _record_paged(monkeypatch, jax_inference)
    seen_port = _record_paged(monkeypatch, port_inference)
    want = Recorder()
    jax_inference.run_vis_inference(cfg, model, params, _loader(), want)
    got = Recorder()
    port_inference.run_vis_inference(cfg, port_arch_model(cfg, params), _loader(), got)

    assert sorted(got.rows) == sorted(want.rows) == [1, 2]
    for vid in (1, 2):
        g, w = got.rows[vid], want.rows[vid]
        np.testing.assert_allclose(g["pred_scores"], w["pred_scores"], rtol=1e-4)
        assert g["pred_labels"] == w["pred_labels"]
        mask_cls, mask_pred, img, out, pad, _ = seen[vid]
        assert rel_err(seen_port[vid][0], mask_cls) <= 1e-4
        assert rel_err(seen_port[vid][1], mask_pred) <= 1e-4
        _, _, queries = jax_minvis.topk_select(mask_cls, len(w["pred_scores"]))
        pre = _jax_prethreshold(mask_pred[np.asarray(queries)], img, out, pad)
        for bits in (g["pred_masks"].unpack(), w["pred_masks"].unpack()):
            differ = bits != (pre > 0)
            assert np.all(np.abs(pre[differ]) < 1e-4)
