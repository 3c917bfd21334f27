"""Video Mask2Former: the port's 3D sine position encoding, clip-joint query
decoder, ``VideoMaskFormer`` and ``_clipformer_video`` against the JAX
package's, on the same seeded weights (fp32, exact deformable op).

Per stage rel <= 1e-5 (position encoding, pixel decoder, clip decoder,
whole model). ``_clipformer_video`` runs the true length T; the JAX eval loop
pads the clip to its power-of-two window bucket, and the padded frames take
part in the clip-joint attention (and the temporal encoding is normalized
by the padded length). So the two agree where the bucket holds exactly T
frames (6 frames in windows of 3: rel <= 1e-4), and at 7 frames (bucket 12)
the port equals the JAX module run on the 7 real frames (rel <= 1e-4),
which is what the reference computes. ``run_vis_inference`` on videos of 6
and 3 frames: scores rel 1e-4, labels equal, mask bits equal but where the
JAX pre-threshold value is within 1e-4 of 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvis_plus_tpu.engine.inference as jax_inference
from dvis_plus_tpu.models.meta.minvis import topk_select
from dvis_plus_tpu.models.segmenter.clip_decoder import ClipMaskedTransformerDecoder as JaxClipDecoder
from dvis_plus_tpu.models.segmenter.position_encoding import position_embedding_sine_3d as jax_pe3d
import dvis_plus_tpu_torch.engine.inference as port_inference
from dvis_plus_tpu_torch.convert import _predictor
from dvis_plus_tpu_torch.models.segmenter.clip_decoder import ClipMaskedTransformerDecoder
from dvis_plus_tpu_torch.models.segmenter.position_encoding import position_embedding_sine_3d
from tests.test_torch_common import (
    images,
    jax_clip_model_and_params,
    nchw,
    port_arch_model,
    random_params,
    rel_err,
)
from tests.test_torch_dvis_online import Recorder, _record_paged
from tests.test_torch_postproc import _jax_prethreshold

torch.set_num_threads(2)


@pytest.mark.parametrize("T,H,W,C", [(1, 4, 6, 32), (5, 7, 3, 64), (12, 2, 2, 256)])
def test_position_embedding_sine_3d_matches_jax(T, H, W, C):
    got = position_embedding_sine_3d(T, H, W, C)
    want = jax_pe3d(T, H, W, C)
    assert got.shape == (T, H, W, C)
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("in_channels", [32, 48])
def test_clip_decoder_matches_jax(in_channels):
    """The decoder alone, 2 clips of 3 frames: 3 x (6, H_l, W_l, in) levels
    (input projections when ``in_channels`` differs from the width)."""
    B, T, C, Q, K = 2, 3, 32, 8, 5
    dec = JaxClipDecoder(num_classes=K, hidden_dim=C, num_queries=Q, num_heads=4,
                         dim_feedforward=64, num_layers=4, mask_dim=32)
    rng = np.random.RandomState(7)
    levels = [rng.randn(B * T, h, w, in_channels).astype(np.float32)
              for h, w in ((2, 3), (4, 6), (8, 12))]
    mf = rng.randn(B * T, 16, 24, 32).astype(np.float32)
    shapes = jax.eval_shape(lambda k, ls, m: dec.init(k, ls, m, T), jax.random.key(0),
                            [jnp.asarray(x) for x in levels], jnp.asarray(mf))
    params = random_params(shapes["params"], seed=8, scale=0.2)
    want = jax.jit(dec.apply, static_argnums=3)(
        {"params": params}, [jnp.asarray(x) for x in levels], jnp.asarray(mf), T)

    sd = {}
    _predictor(params, sd)
    port = ClipMaskedTransformerDecoder(num_classes=K, in_channels=in_channels, hidden_dim=C,
                                        num_queries=Q, num_heads=4, dim_feedforward=64,
                                        num_layers=4, mask_dim=32)
    port.load_state_dict({k.split("predictor.", 1)[1]: torch.from_numpy(np.asarray(v, np.float32))
                          for k, v in sd.items()}, strict=True)
    with torch.inference_mode():
        got = port.eval()([nchw(x) for x in levels], nchw(mf), num_frames=T)
    for k in ("pred_logits", "pred_masks", "pred_embds"):
        assert got[k].shape == want[k].shape, k
        assert rel_err(got[k], want[k]) <= 1e-5, k
    assert got["pred_masks"].shape == (B, Q, T, 16, 24)


def test_video_maskformer_matches_jax_per_stage():
    cfg, model, params = jax_clip_model_and_params()
    x = images(4, seed=40)
    w_mf, w_ms = jax.jit(lambda p, v: model.apply(
        p, v, method=lambda m, imgs: m.pixel_decoder(m.backbone(imgs))))(params, jnp.asarray(x))
    want = jax.jit(model.apply)(params, jnp.asarray(x)[None])
    port = port_arch_model(cfg, params)
    with torch.inference_mode():
        g_mf, g_ms = port.sem_seg_head.pixel_decoder(port.backbone(nchw(x)))
        got = port(nchw(x)[None])
    assert rel_err(g_mf.permute(0, 2, 3, 1), w_mf) <= 1e-5
    for g, w in zip(g_ms, w_ms):
        assert rel_err(g.permute(0, 2, 3, 1), w) <= 1e-5
    for k in ("pred_logits", "pred_masks", "pred_embds"):
        assert got[k].shape == want[k].shape, k
        assert rel_err(got[k], want[k]) <= 1e-5, k


@pytest.mark.parametrize("T", [6, 7])
def test_clipformer_video_matches_jax(T):
    cfg, model, params = jax_clip_model_and_params()
    x = images(T, seed=41)
    wl, wm, _ = jax_inference._clipformer_video(cfg, model, params, x, {}, 3)
    with torch.inference_mode():
        gl, gm, aux = port_inference._clipformer_video(cfg, port_arch_model(cfg, params), x, 3)
    assert aux is None and gm.shape == np.asarray(wm).shape == (8, T, 16, 24)
    if T == 6:  # the JAX bucket holds 2 windows = 6 frames: no padding
        assert rel_err(gl, wl) <= 1e-4 and rel_err(gm, wm) <= 1e-4
        return
    # bucket of 4 windows: 5 padded frames join the JAX clip's attention
    assert rel_err(gl, wl) > 1e-4
    true_t = jax.jit(model.apply)(params, jnp.asarray(x)[None])
    assert rel_err(gl, true_t["pred_logits"][0]) <= 1e-4
    assert rel_err(gm, true_t["pred_masks"][0]) <= 1e-4


def _loader():
    """Videos of 6 and 3 frames: with window 3 the JAX buckets hold them
    exactly."""
    for vid, (T, img, out) in enumerate([(6, (64, 96), (48, 72)), (3, (56, 96), (96, 144))], 1):
        x = images(T, seed=42 + vid)
        x[:, img[0]:] = 0.0
        yield {"images": x, "image_size": np.asarray(img), "height": out[0],
               "width": out[1], "video_id": vid}


def test_clip_run_vis_inference_matches_jax(monkeypatch):
    cfg, model, params = jax_clip_model_and_params()
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
        _, _, queries = topk_select(mask_cls, len(w["pred_scores"]))
        pre = _jax_prethreshold(mask_pred[np.asarray(queries)], img, out, pad)
        for bits in (g["pred_masks"].unpack(), w["pred_masks"].unpack()):
            differ = bits != (pre > 0)
            assert np.all(np.abs(pre[differ]) < 1e-4)


def test_image_maskformer_matches_jax():
    """The image Mask2Former (``maskformer``): B images as B one-frame
    clips, on Video Mask2Former's weights (the same tree): logits and masks
    rel <= 1e-5; and the eval loop's forward (``video_logits_masks``, the
    whole video as one clip) against the JAX loop's, 6 frames in windows of
    3 (the bucket holds them exactly): rel <= 1e-4."""
    from dvis_plus_tpu.models.meta.video_maskformer import ImageMaskFormer as JaxImageMaskFormer

    import copy

    cfg, _, params = jax_clip_model_and_params()
    cfg = copy.deepcopy(cfg)  # the cached configuration stays video_maskformer's
    cfg.model.meta_architecture = "maskformer"
    jax_model = JaxImageMaskFormer(cfg.model)
    port = port_arch_model(cfg, params)
    assert type(port).__name__ == "ImageMaskFormer"
    x = images(2, seed=44)
    want = jax.jit(jax_model.apply)(params, jnp.asarray(x))
    with torch.inference_mode():
        got = port(nchw(x))
    assert got["pred_masks"].shape == np.asarray(want["pred_masks"]).shape == (2, 8, 1, 16, 24)
    for k in ("pred_logits", "pred_masks"):
        assert rel_err(got[k], want[k]) <= 1e-5, k
    video = images(6, seed=45)
    wl, wm, _ = jax_inference.video_logits_masks(cfg, jax_model, params, video, {}, 3)
    with torch.inference_mode():
        gl, gm, aux = port_inference.video_logits_masks(cfg, port, video, 3)
    assert aux is None and gm.shape == (8, 6, 16, 24)
    assert rel_err(gl, wl) <= 1e-4 and rel_err(gm, np.asarray(wm)[:, :6]) <= 1e-4
