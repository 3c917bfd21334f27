"""The JAX pieces that no entry point reaches, held against their JAX functions
on the same numpy inputs: ``DETRTransformer`` (rel <= 1e-5, fp32),
``mask_nms_keep`` (keep equal, on random masks and thresholds),
``hard_softmax`` (forward equal; the straight-through gradient rel <= 1e-6),
``evaluate_instances`` (every metric within 1e-9) and ``semantic_tta``
(within 1e-6); and ``backbone.swin_fast_softmax``: the port's bf16-score
window attention against the JAX module's bf16 path (rel <= 1e-2), with the
port's plain op taking it in training and eval on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import random_params, rel_err

torch.set_num_threads(2)


@pytest.mark.parametrize("return_intermediate", [True, False])
def test_detr_transformer_matches_jax(return_intermediate):
    from dvis_plus_tpu.models.segmenter.detr_transformer import DETRTransformer as JaxDETR
    from dvis_plus_tpu_torch.convert import detr_state_dict_from_jax
    from dvis_plus_tpu_torch.models.segmenter.detr_transformer import DETRTransformer

    kw = dict(d_model=32, num_heads=4, num_encoder_layers=2, num_decoder_layers=3, dim_feedforward=64,
              return_intermediate=return_intermediate)
    rng = np.random.RandomState(0)
    src = rng.randn(2, 24, 32).astype(np.float32)
    pos = rng.randn(1, 24, 32).astype(np.float32)
    qe = rng.randn(6, 32).astype(np.float32)
    jmod = JaxDETR(**kw)
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), src, pos, qe)
    params = random_params(shapes["params"], seed=2, scale=0.2)
    want_outs, want_mem = jmod.apply({"params": params}, src, pos, qe)
    model = DETRTransformer(**kw)
    model.load_state_dict(detr_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        outs, mem = model(torch.from_numpy(src), torch.from_numpy(pos), torch.from_numpy(qe))
    assert outs.shape == want_outs.shape == ((3 if return_intermediate else 1), 2, 6, 32)
    assert rel_err(outs.numpy(), want_outs) <= 1e-5
    assert rel_err(mem.numpy(), want_mem) <= 1e-5


@pytest.mark.parametrize("seed", range(4))
def test_mask_nms_keep_matches_jax(seed):
    from dvis_plus_tpu.models.meta.daq import mask_nms_keep as jax_nms
    from dvis_plus_tpu_torch.models.meta.daq import mask_nms_keep

    rng = np.random.RandomState(seed)
    S = 9
    masks = np.full((S, 12, 12), -5.0, np.float32)
    for s in range(S):
        y, x, h, w = rng.randint(0, 6), rng.randint(0, 6), rng.randint(3, 7), rng.randint(3, 7)
        masks[s, y:y + h, x:x + w] = 5.0
    masks[3] = masks[1]  # an exact duplicate
    masks[5] = -5.0  # an empty mask
    scores = rng.rand(S).astype(np.float32)
    scores[7] = scores[2]  # a tie: the stable order decides
    valid = rng.rand(S) > 0.2
    for thr in (0.3, 0.6, 0.9):
        want = np.asarray(jax_nms(jnp.asarray(masks), jnp.asarray(scores), jnp.asarray(valid), thr))
        got = mask_nms_keep(torch.from_numpy(masks), torch.from_numpy(scores),
                            torch.from_numpy(valid), thr)
        np.testing.assert_array_equal(got.numpy(), want)


def test_mask_nms_keep_suppresses_a_duplicate():
    from dvis_plus_tpu_torch.models.meta.daq import mask_nms_keep

    masks = torch.full((3, 8, 8), -5.0)
    masks[0, :4, :4] = masks[1, :4, :4] = masks[2, 4:, 4:] = 5.0
    keep = mask_nms_keep(masks, torch.tensor([0.9, 0.5, 0.8]), torch.ones(3, dtype=torch.bool), 0.6)
    assert keep.tolist() == [True, False, True]


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_hard_softmax_matches_jax(axis):
    from dvis_plus_tpu.models.daq.slot_attention import hard_softmax as jax_hard_softmax
    from dvis_plus_tpu_torch.models.daq.slot_attention import hard_softmax

    rng = np.random.RandomState(axis + 5)
    logits = rng.randn(4, 5, 6).astype(np.float32)
    weights = rng.randn(4, 5, 6).astype(np.float32)
    want = jax_hard_softmax(jnp.asarray(logits), axis)
    want_g = jax.grad(lambda x: (jax_hard_softmax(x, axis) * weights).sum())(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = hard_softmax(x, axis)
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-7)
    assert set(np.unique(np.round(got.detach().numpy(), 6))) <= {0.0, 1.0}
    assert rel_err(x.grad.numpy(), np.asarray(want_g)) <= 1e-6


def _seg(m):
    from dvis_plus_tpu_torch.utils import rle

    e = rle.encode(m.astype(np.uint8))
    return {"size": e["size"], "counts": e["counts"].decode()}


def test_evaluate_instances_matches_jax():
    from dvis_plus_tpu.evaluation.instance_evaluation import evaluate_instances as jax_eval
    from dvis_plus_tpu_torch.evaluation.instance_evaluation import evaluate_instances

    rng = np.random.RandomState(3)
    gt, pred = [], []
    for image_id in range(1, 5):
        for k in range(3):
            m = np.zeros((20, 24), bool)
            y, x = rng.randint(0, 10), rng.randint(0, 12)
            m[y:y + 8, x:x + 9] = True
            gt.append({"image_id": image_id, "category_id": 1 + k % 2, "segmentation": _seg(m),
                       "iscrowd": int(k == 2 and image_id == 2)})
            p = np.roll(m, rng.randint(-3, 4), axis=int(rng.randint(0, 2)))
            pred.append({"image_id": image_id, "category_id": 1 + (k + image_id) % 2,
                         "score": float(rng.rand()), "segmentation": _seg(p)})
    want = jax_eval(gt, pred, max_dets=10)
    got = evaluate_instances(gt, pred, max_dets=10)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])
    assert 0.0 < got["AP"] < 1.0


@pytest.mark.parametrize("scales,flip", [((1.0,), True), ((0.5, 1.0, 1.5), True), ((0.75,), False)])
def test_semantic_tta_matches_jax(scales, flip):
    from dvis_plus_tpu.evaluation.instance_evaluation import semantic_tta as jax_tta
    from dvis_plus_tpu_torch.evaluation.instance_evaluation import semantic_tta

    rng = np.random.RandomState(1)
    image = rng.randint(0, 255, (16, 20, 3)).astype(np.uint8)
    proj = rng.rand(3, 4).astype(np.float32)

    def predict(img):  # a position- and content-dependent stand-in for a model
        x = img.astype(np.float32) / 255.0
        ramp = np.linspace(0.0, 1.0, img.shape[1], dtype=np.float32)[None, :, None]
        logits = x @ proj + ramp
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    want = jax_tta(predict, image, scales=scales, flip=flip)
    got = semantic_tta(predict, image, scales=scales, flip=flip)
    assert got.shape == (16, 20, 4)
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# swin_fast_softmax
# ---------------------------------------------------------------------------


def _window_attention_pair(mask: bool):
    """A JAX ``WindowAttention`` with ``fast_softmax`` in bf16, the port's
    with the same weights, bf16 inputs, and the shifted-window mask."""
    from dvis_plus_tpu.models.backbones.swin import WindowAttention as JaxWA
    from dvis_plus_tpu.models.backbones.swin import _shift_mask
    from dvis_plus_tpu_torch.models.backbones.swin import WindowAttention

    C, H, ws, B = 64, 2, 7, 2
    jmod = JaxWA(dim=C, num_heads=H, window_size=ws, dtype=jnp.bfloat16, fast_softmax=True)
    m = np.asarray(_shift_mask(14, 14, ws, 3)) if mask else None  # (4, 49, 49)
    x = np.random.RandomState(4).randn(B * 4, ws * ws, C).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), xb, m)
    # the parity tests' weights: scores and a bias of order 1 (larger scores
    # round in bf16 to steps of their exp's several percent, in either package)
    params = random_params(shapes["params"], seed=6)
    want = jmod.apply({"params": params}, xb, None if m is None else jnp.asarray(m))
    port = WindowAttention(C, H, ws, fast_softmax=True)
    sd = {"relative_position_bias_table": params["relative_position_bias_table"],
          "relative_position_index": port.relative_position_index.numpy(),
          "qkv.weight": params["qkv"]["kernel"].T, "qkv.bias": params["qkv"]["bias"],
          "proj.weight": params["proj"]["kernel"].T, "proj.bias": params["proj"]["bias"]}
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    xt = torch.from_numpy(x).bfloat16()
    mt = None if m is None else torch.from_numpy(m.astype(np.float32))
    return port, xt, mt, np.asarray(want, np.float32)


@pytest.mark.parametrize("mask", [False, True], ids=["plain", "shifted"])
def test_swin_fast_softmax_matches_jax_bf16_path(mask):
    port, x, m, want = _window_attention_pair(mask)
    with torch.no_grad():
        got = port.eval()(x, m)
        got_train = port.train()(x, m)
        port.fast_softmax = False
        fp32_scores = port.eval()(x, m)
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float().numpy(), want) <= 1e-2
    assert torch.equal(got, got_train)  # training takes the same plain form
    assert not torch.equal(got, fp32_scores)  # the bf16-score path was taken


def test_swin_backbone_builds_with_fast_softmax():
    from dvis_plus_tpu_torch.config import BackboneConfig
    from dvis_plus_tpu_torch.models.backbones.swin import build_swin

    cfg = BackboneConfig(name="swin_tiny", swin_embed_dim=32, swin_depths=(1, 1, 1, 1),
                         swin_num_heads=(1, 2, 4, 8), swin_window_size=4, swin_fast_softmax=True)
    model = build_swin(cfg).eval()
    assert all(blk.attn.fast_softmax for layer in model.layers for blk in layer.blocks)
    with torch.no_grad():
        out = model(torch.randn(1, 3, 32, 48).bfloat16())
    assert out["res5"].dtype == torch.bfloat16 and torch.isfinite(out["res5"].float()).all()
