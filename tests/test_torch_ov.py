"""The port's open-vocabulary modules against the JAX package's, from the
same numpy-seeded inputs and weights (carried across by
``convert.state_dict_from_jax``): the OV heads, the geometric ensemble and
mask pooling (rel <= 1e-6), the bilinear resize both packages threshold
after, the CLIP ConvNeXt and RN50 trunks, the masked attention pool, the
text tower and the FC-CLIP decoder (rel <= 1e-5 per stage), the void rows
of ``full_classifier`` in every merge mode, the tracker's and refiner's OV
heads over two windows (rel <= 2e-4), and the converter's round trip
through ``core/zoo_convert.py`` for the three OV trees.

Binary masks (``> 0`` after a bilinear resize) decide which pixels a pooled
feature averages; every test that thresholds asserts that the values it
thresholds lie more than 1e-4 from 0 (``margin``), so that the two packages'
pooled sets are equal and are compared exactly."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_common import (
    H_IN,
    OV_CC,
    OV_NT,
    W_IN,
    jax_ov_model_and_params,
    margin,
    nchw,
    ov_text_classifier,
    rel_err,
)

MARGIN = 1e-4


def nhwc(x: torch.Tensor) -> np.ndarray:
    return np.moveaxis(x.detach().float().numpy(), 1, -1)


def frames(T=2, seed=1):
    return np.random.RandomState(seed).randn(T, H_IN, W_IN, 3).astype(np.float32)


# ---------------------------------------------------------------------------
# heads, ensemble, pooling, the resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classification_logits(dtype):
    """Cosine logits with the clamped scale (exp(5) > 100 clamps), max over
    each class's templates and over the void block; a bf16 embedding against
    the fp32 classifier promotes to fp32 in both packages."""
    from dvis_plus_tpu.models.ov.heads import get_classification_logits as jax_fn
    from dvis_plus_tpu_torch.models.ov.heads import get_classification_logits

    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, OV_CC).astype(np.float32)
    tc = rng.randn(sum(OV_NT), OV_CC).astype(np.float32)
    for scale in (np.float32(2.3), np.float32(5.0)):
        xj = jnp.asarray(x, dtype)
        want = jax_fn(xj, jnp.asarray(tc), jnp.asarray(scale), OV_NT)
        got = get_classification_logits(torch.tensor(np.asarray(xj.astype(jnp.float32))).to(
            getattr(torch, dtype)), torch.from_numpy(tc), torch.tensor(scale), OV_NT)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        assert got.shape == (3, 7, len(OV_NT))
        assert rel_err(got.numpy(), want) <= (1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("sizes", [((120, 160), (15, 20)), ((32, 48), (4, 6)), ((16, 24), (16, 24)),
                                   ((30, 40), (8, 10))])
def test_bilinear_resize_equals_jax(sizes):
    """``jax.image.resize(..., "bilinear", antialias=False)`` and
    ``F.interpolate(..., "bilinear", align_corners=False)`` agree to fp32
    rounding at the ratios the OV heads use (stride 4 to stride 32, the
    decoder's own size) and a non-integer one."""
    from dvis_plus_tpu_torch.models.ov.heads import resize_masks

    (h, w), (H, W) = sizes
    m = np.random.RandomState(1).randn(2, 5, h, w).astype(np.float32)
    want = jax.image.resize(jnp.asarray(m), (2, 5, H, W), method="bilinear", antialias=False)
    got = resize_masks(torch.from_numpy(m), (H, W))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_pooling_exact_sets(dtype):
    """Stride-4 masks pooled over stride-32 features (an 8x downsample) and
    over features of their own size; every resized logit lies more than
    1e-4 from 0, the binary sets are equal, and an empty mask pools to 0."""
    from dvis_plus_tpu.models.ov.heads import mask_pooling as jax_fn
    from dvis_plus_tpu_torch.models.ov.heads import mask_pooling, resize_masks

    rng = np.random.RandomState(2)
    for (h, w), (H, W) in (((120, 160), (15, 20)), ((16, 24), (16, 24))):
        x = rng.randn(2, H, W, 8).astype(np.float32)
        m = rng.randn(2, 4, h, w).astype(np.float32)
        m[0, 1] = -1.0  # an empty mask
        rs = resize_masks(torch.from_numpy(m), (H, W))
        assert margin(rs) > MARGIN
        want_set = np.asarray(jax.image.resize(jnp.asarray(m), (2, 4, H, W), "bilinear",
                                               antialias=False)) > 0
        assert np.array_equal(rs.numpy() > 0, want_set)
        xj = jnp.asarray(x, dtype)
        want = jax_fn(xj, jnp.asarray(m))
        got = mask_pooling(torch.from_numpy(np.moveaxis(np.asarray(xj.astype(jnp.float32)), -1, 1).copy()
                                            ).to(getattr(torch, dtype)), torch.from_numpy(m))
        assert rel_err(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= (
            1e-6 if dtype == "float32" else 1e-2)
        assert float(got[0, 1].abs().max()) == 0.0


def test_geometric_ensemble():
    from dvis_plus_tpu.models.ov.heads import geometric_ensemble as jax_fn
    from dvis_plus_tpu_torch.models.ov.heads import geometric_ensemble

    rng = np.random.RandomState(3)
    a = (4 * rng.randn(5, 7, 6)).astype(np.float32)
    b = (4 * rng.randn(5, 7, 6)).astype(np.float32)
    a[0, 0, :5] = -80.0  # saturated probabilities reach the 1e-20 clip
    overlap = np.array([1, 0, 1, 0, 0], np.float32)
    want = jax_fn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(overlap), 0.4, 0.8)
    got = geometric_ensemble(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(overlap), 0.4, 0.8)
    assert rel_err(got.numpy(), want) <= 1e-6


# ---------------------------------------------------------------------------
# trunks, attention pool, text tower, decoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["convnext", "resnet"])
def test_clip_trunk_per_stage(kind):
    cfg, jm, params, pm = jax_ov_model_and_params(kind, "minvis_ov")
    x = frames()
    want = jm.apply(params, jnp.asarray(x), method=lambda m, im: m.backbone(im))
    with torch.no_grad():
        got = pm.backbone(nchw(x))
    assert set(got) == {"res2", "res3", "res4", "res5", "clip_vis_dense"}
    for k in got:
        assert rel_err(nhwc(got[k]), want[k]) <= 1e-5, k
    assert pm.backbone.out_channels == {k: int(want[k].shape[-1]) for k in ("res2", "res3", "res4", "res5")}


@pytest.mark.parametrize("kind", ["convnext", "resnet"])
def test_pool_clip(kind):
    """The out-of-vocabulary head on stride-4 masks: ConvNeXt = binary mask
    pooling + trunk head norm + MLP; RN50 = the masked attention pool (the
    positional table resized from 3x3 to the 2x3 map, one query a mask,
    -1e9 outside it, an empty mask attending everywhere)."""
    cfg, jm, params, pm = jax_ov_model_and_params(kind, "minvis_ov")
    rng = np.random.RandomState(4)
    dense = rng.randn(2, H_IN // 32, W_IN // 32, 256 if kind == "resnet" else 40).astype(np.float32)
    masks = rng.randn(2, 5, H_IN // 4, W_IN // 4).astype(np.float32)
    masks[1, 2] = -3.0  # empty
    with torch.no_grad():
        from dvis_plus_tpu_torch.models.ov.heads import resize_masks

        assert margin(resize_masks(torch.from_numpy(masks), dense.shape[1:3])) > MARGIN
        got = pm.pool_clip(nchw(dense), torch.from_numpy(masks))
    want = jm.apply(params, jnp.asarray(dense), jnp.asarray(masks), method=type(jm).pool_clip)
    assert got.shape == (2, 5, OV_CC)
    assert rel_err(got.numpy(), want) <= 1e-5


def test_text_tower():
    """Causal mask, EOT pooling by argmax of the ids (the highest id ends
    each row, anywhere in it), text_projection; a 2-layer tower of width 64,
    from an open_clip-named state dict through both packages' loaders."""
    from dvis_plus_tpu.models.ov.clip_backbone import CLIPTextEncoder as JaxText
    from dvis_plus_tpu.models.ov.clip_backbone import convert_open_clip_text
    from dvis_plus_tpu_torch.models.ov.clip_backbone import text_encoder_for, text_state_dict
    from tests.test_torch_common import open_clip_text_state_dict

    sd = open_clip_text_state_dict(prefix="text.")
    enc = text_encoder_for(text_state_dict(sd))
    tokens = np.random.RandomState(5).randint(1, 90, size=(4, 12)).astype(np.int32)
    for i, L in enumerate((3, 12, 7, 1)):
        tokens[i, L - 1] = 99  # the end-of-text id, the highest
        tokens[i, L:] = 0
    jax_enc = JaxText(vocab_size=100, context_length=16, width=64, heads=1, layers=2, embed_dim=OV_CC)
    want = jax_enc.apply({"params": convert_open_clip_text(sd, layers=2, heads=1)}, jnp.asarray(tokens))
    with torch.no_grad():
        got = enc(torch.from_numpy(tokens))
    assert got.shape == (4, OV_CC) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("kind", ["convnext", "resnet"])
def test_ov_segmenter_forward(kind):
    """The FC-CLIP decoder on the pixel decoder's outputs: logits (with the
    appended void row), masks, embeds, and the dense CLIP features; the
    head's mask pooling thresholds the decoder's last masks."""
    cfg, jm, params, pm = jax_ov_model_and_params(kind, "minvis_ov")
    tc, nt, _ = ov_text_classifier()
    x = frames()
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(tc), nt)
    assert margin(want["pred_masks"]) > MARGIN
    with torch.no_grad():
        got = pm(nchw(x), torch.from_numpy(tc), nt)
    assert got["pred_logits"].shape == (2, 8, len(nt))
    for k in ("pred_logits", "pred_masks", "pred_embds", "pred_embds_without_norm"):
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k
    assert rel_err(nhwc(got["clip_vis_dense"]), want["clip_vis_dense"]) <= 1e-5


@pytest.mark.parametrize("mode,void_index", [("coco", None), ("mean", None), ("max", None),
                                             ("coco", 1), ("max", 2)])
def test_full_classifier(mode, void_index):
    """Three void rows (``void_embedding`` + two ``additional`` ones):
    merged by ``coco`` (row 0), ``mean`` or ``max`` (all rows), or a set's
    private row; normalized, cast to the classifier's dtype."""
    from dvis_plus_tpu.models.meta.ov import OVSegmenter as JaxSeg
    from dvis_plus_tpu_torch.cli_ov import build_ov_model
    from dvis_plus_tpu_torch.convert import state_dict_from_jax

    cfg, jm, params, _ = jax_ov_model_and_params("convnext", "minvis_ov")
    cfg = copy.deepcopy(cfg)
    cfg.model.ov.num_void_embeddings = 3
    cfg.model.ov.void_merge_mode = mode
    jm3 = JaxSeg(cfg.model)
    p3 = {"params": dict(params["params"])}
    p3["params"]["void_embedding"] = np.random.RandomState(6).randn(3, OV_CC).astype(np.float32)
    pm = build_ov_model(cfg)
    pm.load_state_dict(state_dict_from_jax(p3), strict=True)
    assert pm.additional_void_embedding.weight.shape == (2, OV_CC)
    tc, _, _ = ov_text_classifier()
    want = jm3.apply(p3, jnp.asarray(tc), void_index, method=JaxSeg.full_classifier)
    with torch.no_grad():
        got = pm.full_classifier(torch.from_numpy(tc), void_index)
    rows = 3 if (mode == "max" and void_index is None) else 1
    assert got.shape == (tc.shape[0] + rows, OV_CC)
    assert rel_err(got.numpy(), want) <= 1e-6


# ---------------------------------------------------------------------------
# tracker and refiner OV heads
# ---------------------------------------------------------------------------


def test_tracker_ov_head_two_windows():
    """DVIS++ online OV over two windows of 3 frames, the carry passed back:
    the tracker's OV logits (merge + raw mask features pooled under its
    masks), masks and embeds per window."""
    cfg, jm, params, pm = jax_ov_model_and_params("convnext", "dvis_online_ov")
    tc, nt, _ = ov_text_classifier()
    x = frames(6, seed=2)
    state, jstate = None, None
    for w in range(2):
        xw = x[3 * w : 3 * w + 3]
        _, jt, jstate = jm.apply(params, jnp.asarray(xw)[None], jnp.asarray(tc), nt, state=jstate)
        assert margin(jt["pred_masks"]) > MARGIN
        with torch.no_grad():
            _, pt, state = pm(nchw(xw)[None], torch.from_numpy(tc), nt, state=state)
        assert "mask_feature_proj" not in dict(pm.tracker.named_children())
        assert rel_err(pt["pred_logits"].numpy(), jt["pred_logits"]) <= 2e-4
        assert rel_err(pt["pred_masks"].numpy(), jt["pred_masks"]) <= 2e-4
        assert rel_err(pt["pred_embds"].numpy(), jt["pred_embds"]) <= 2e-4
        assert np.array_equal(pt["indices"].numpy(), np.asarray(jt["indices"]))


def test_refiner_ov_head_two_windows():
    """DVIS++ offline OV: two streamed windows, the refiner's embed pass
    over the 6 frames, its mask head a window, the in-vocabulary pooling
    accumulated over the windows and ``refine_ov_classify``; and the whole
    clip forward of the refiner's OV head (``DVISOfflineOV.__call__``)."""
    from dvis_plus_tpu.models.meta.ov import DVISOfflineOV as JaxOff

    cfg, jm, params, pm = jax_ov_model_and_params("convnext", "dvis_offline_ov")
    tc, nt, _ = ov_text_classifier()
    x = frames(6, seed=3)
    jinst, jframe, jmf, pinst, pframe, pmf = [], [], [], [], [], []
    state, jstate = None, None
    for w in range(2):
        xw = x[3 * w : 3 * w + 3]
        seg, jt, jstate = jm.apply(params, jnp.asarray(xw)[None], jnp.asarray(tc), nt, state=jstate,
                                   method=JaxOff.online_forward)
        jinst.append(jt["pred_embds"])
        jframe.append(seg["pred_embds_without_norm"].reshape(1, 3, -1, seg["pred_embds_without_norm"].shape[-1]))
        jmf.append(seg["mask_features"].reshape((1, 3) + seg["mask_features"].shape[1:]))
        with torch.no_grad():
            inst, frame, mf, _, state = pm.online_step(nchw(xw)[None], torch.from_numpy(tc), nt, state)
        pinst.append(inst)
        pframe.append(frame)
        pmf.append(mf)
    jr = jm.apply(params, jnp.concatenate(jinst, 1), jnp.concatenate(jframe, 1),
                  method=JaxOff.refine_embeds)
    with torch.no_grad():
        pr = pm.refine_embeds(torch.cat(pinst, 1), torch.cat(pframe, 1))
    assert rel_err(pr["fused"].numpy(), jr["fused"]) <= 2e-4
    assert rel_err(pr["mask_embed"].numpy(), jr["mask_embed"]) <= 2e-4
    jsum = psum = 0.0
    jcnt = pcnt = 0.0
    for w in range(2):
        jw = jm.apply(params, jr["mask_embed"][:, 3 * w : 3 * w + 3], jmf[w], method=JaxOff.refine_mask_window)
        assert margin(jw) > MARGIN
        with torch.no_grad():
            pw = pm.refine_mask_window(pr["mask_embed"][:, 3 * w : 3 * w + 3], pmf[w])
        assert rel_err(pw.numpy(), jw) <= 2e-4
        jm_ = (np.asarray(jw[0]) > 0).astype(np.float32)
        assert np.array_equal(jm_, (pw[0] > 0).float().numpy())
        jsum = jsum + np.einsum("qthw,thwc->qc", jm_, np.asarray(jmf[w][0]))
        jcnt = jcnt + jm_.sum(axis=(1, 2, 3))
        psum = psum + torch.einsum("qthw,tchw->qc", (pw[0] > 0).float(), pmf[w][0])
        pcnt = pcnt + (pw[0] > 0).float().sum(dim=(1, 2, 3))
    jpool = (jsum / np.maximum(jcnt[:, None], 1e-8))[None]
    ppool = (psum / torch.clamp(pcnt[:, None], min=1e-8))[None]
    want = jm.apply(params, jr["fused"], jnp.asarray(jpool), jnp.asarray(tc), nt, None,
                    method=JaxOff.refine_ov_classify)
    with torch.no_grad():
        got = pm.refine_ov_classify(pr["fused"], ppool, torch.from_numpy(tc), nt)
    assert got.shape == (1, 8, len(nt))
    assert rel_err(got.numpy(), want) <= 2e-4
    # the whole clip in one forward (the refiner's own pooling over T)
    _, _, jref, _ = jm.apply(params, jnp.asarray(x[:3])[None], jnp.asarray(tc), nt)
    with torch.no_grad():
        _, _, pref, _ = pm(nchw(x[:3])[None], torch.from_numpy(tc), nt)
    assert margin(jref["pred_masks"]) > MARGIN
    for k in ("pred_logits", "pred_masks"):
        assert rel_err(pref[k].numpy(), jref[k]) <= 2e-4, k


# ---------------------------------------------------------------------------
# converter round trips
# ---------------------------------------------------------------------------


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("kind,arch", [("convnext", "minvis_ov"), ("convnext", "dvis_online_ov"),
                                       ("convnext", "dvis_offline_ov"), ("resnet", "dvis_offline_ov")])
def test_converter_round_trip(kind, arch):
    """JAX tree -> the port's state dict (which loads strictly) -> the zoo
    converter's ``convert_reference_checkpoint``: every leaf comes back, in
    the same place, bit for bit."""
    from dvis_plus_tpu.core.zoo_convert import convert_reference_checkpoint
    from dvis_plus_tpu_torch.convert import state_dict_from_jax

    cfg, _, params, pm = jax_ov_model_and_params(kind, arch)
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    assert set(sd) == set(state_dict_from_jax(params))
    back = convert_reference_checkpoint(sd, cfg)
    want, got = dict(_flat(params)), dict(_flat(back))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and np.array_equal(got[k], v), k
