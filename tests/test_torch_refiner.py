"""The port's temporal refiner against the JAX ``TemporalRefiner`` (fp32,
rel <= 1e-5): ``embed_pass`` with and without ``time_mask``,
``mask_window`` and the whole-video forward, on T = 7 frames (not a multiple
of the window).

The time-masked case runs both sides on the JAX eval loop's bucketed input
(T = 7 padded to 12 by replicating the last frame); the port's real-frame
outputs there must also equal its own unpadded run, which is why the port's
eval loop may run the true length."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.models.refiner.temporal_refiner import TemporalRefiner as JaxRefiner
from dvis_plus_tpu_torch import convert
from dvis_plus_tpu_torch.models.refiner.temporal_refiner import TemporalRefiner
from tests.test_torch_common import random_params, rel_err

torch.set_num_threads(2)

B, T, TB, Q, FQ, C, CM, HM, WM, K = 1, 7, 12, 8, 6, 64, 32, 12, 16, 5
KW = dict(num_classes=K, hidden_dim=C, feedforward_dim=64, num_heads=4, num_layers=2, mask_dim=CM)
TOL = 1e-5


@functools.cache
def _models():
    jmodel = JaxRefiner(**KW)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.key(0), jnp.zeros((B, 2, Q, C)), jnp.zeros((B, 2, FQ, C)),
        jnp.zeros((B, 2, HM, WM, CM)),
    )
    params = random_params(shapes, seed=4, scale=0.1)
    sd = {}
    convert._refiner(params["params"], sd)
    model = TemporalRefiner(**KW)
    model.load_state_dict(
        {k[len("refiner."):]: torch.from_numpy(v) for k, v in sd.items()}, strict=True
    )
    return jmodel, params, model.eval()


def _inputs(seed=5):
    rng = np.random.RandomState(seed)
    inst = rng.randn(B, T, Q, C).astype(np.float32)
    frame = rng.randn(B, T, FQ, C).astype(np.float32)
    mf = rng.randn(B, T, HM, WM, CM).astype(np.float32)  # NHWC, the JAX layout
    return inst, frame, mf


def _pad_replicate(x, Tb):
    return np.concatenate([x, np.repeat(x[:, -1:], Tb - x.shape[1], axis=1)], axis=1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _check(got: dict, want: dict, keys):
    for k in keys:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        assert rel_err(g, w) <= TOL, k


@pytest.mark.parametrize("time_masked", [False, True])
def test_embed_pass_matches_jax(time_masked):
    jmodel, params, model = _models()
    inst, frame, _ = _inputs()
    tm = None
    if time_masked:
        inst, frame = _pad_replicate(inst, TB), _pad_replicate(frame, TB)
        tm = np.arange(TB)[None] < T
    want = jmodel.apply(params, jnp.asarray(inst), jnp.asarray(frame),
                        time_mask=None if tm is None else jnp.asarray(tm),
                        method=JaxRefiner.embed_pass)
    with torch.inference_mode():
        got = model.embed_pass(_t(inst), _t(frame), None if tm is None else _t(tm))
    _check(got, want, ("pred_logits", "mask_embed", "pred_embds"))
    if time_masked:  # real frames equal the unpadded run
        with torch.inference_mode():
            plain = model.embed_pass(_t(inst[:, :T]), _t(frame[:, :T]))
        assert rel_err(got["pred_logits"], plain["pred_logits"]) <= TOL
        for k in ("mask_embed", "pred_embds"):
            assert rel_err(got[k][:, :T], plain[k]) <= TOL, k


def test_mask_window_matches_jax():
    jmodel, params, model = _models()
    _, _, mf = _inputs()
    membd = np.random.RandomState(6).randn(B, 3, Q, CM).astype(np.float32)
    want = jmodel.apply(params, jnp.asarray(membd), jnp.asarray(mf[:, :3]),
                        method=JaxRefiner.mask_window)
    got = model.mask_window(_t(membd), _t(np.moveaxis(mf[:, :3], -1, 2)))
    assert got.shape == want.shape
    assert rel_err(got.numpy(), want) <= TOL


def test_forward_matches_jax():
    jmodel, params, model = _models()
    inst, frame, mf = _inputs()
    want = jmodel.apply(params, jnp.asarray(inst), jnp.asarray(frame), jnp.asarray(mf))
    with torch.inference_mode():
        got = model(_t(inst), _t(frame), _t(np.moveaxis(mf, -1, 2)))
    _check(got, want, ("pred_logits", "pred_masks", "pred_embds"))
