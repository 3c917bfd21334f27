"""The gradient of the port's deformable attention against the JAX package's.

On the CPU the port's op is its plain twin, differentiated by autograd; on
the card its backward is the kernel ``csrc/msdeform_bwd.cu``, held against
this same autograd by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
The JAX package has no backward TPU kernel: ``jax.grad`` of the exact op
(``ops/msdeform.py::ms_deform_attn``) is XLA's, and the clamped form's
(``ops/msdeform_pallas.py::ms_deform_attn_local``, its forward the Pallas
kernel in interpret mode) is its ``custom_vjp``, the gradient of
``_local_exact_oracle``. Both are compared with respect to the value, the
locations and the weights, fp32, rel <= 1e-5 of the largest gradient
(reduction-order noise), on the same seeded inputs and output gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.ops.msdeform import ms_deform_attn as jax_exact
from dvis_plus_tpu.ops.msdeform_pallas import ms_deform_attn_local
from dvis_plus_tpu_torch.ops import msdeform
from tests.test_torch_common import rel_err
from tests.test_torch_msdeform import RADIUS, SHAPES, _case, _extractor_case

torch.set_num_threads(2)
TOL = 1e-5


def _port_grads(value, loc, attn, g, shapes, radius=None):
    v, l, a = (torch.from_numpy(x).requires_grad_() for x in (value, loc, attn))
    out = msdeform.ms_deform_attn(v, shapes, l, a, radius=radius)
    out.backward(torch.from_numpy(g))
    return [t.grad.numpy() for t in (v, l, a)]


def _jax_grads(fn, value, loc, attn, g):
    _, vjp = jax.vjp(fn, jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _out_grad(loc, value, seed):
    return np.random.RandomState(seed).randn(loc.shape[0], loc.shape[1],
                                             value.shape[2] * value.shape[3]).astype(np.float32)


@pytest.mark.parametrize("seed", [1, 4])
def test_exact_form_gradients_match_jax(seed):
    value, loc, attn = _case(seed=seed, B=2)
    g = _out_grad(loc, value, seed + 10)
    got = _port_grads(value, loc, attn, g, SHAPES)
    want = _jax_grads(lambda v, l, a: jax_exact(v, SHAPES, l, a), value, loc, attn, g)
    for name, x, y in zip(("value", "locations", "weights"), got, want):
        assert np.abs(y).max() > 0, name
        assert rel_err(x, y) <= TOL, name


def test_clamped_form_gradients_match_jax_custom_vjp():
    """``ms_deform_attn_local``'s forward runs the Pallas kernel in
    interpret mode; its gradient is the VJP of the exact math on the clamped
    locations, which gives a clamped coordinate no gradient."""
    value, loc, attn = _case(seed=2, M=2, D=8, P=2, spread=4.0)
    g = _out_grad(loc, value, 12)
    got = _port_grads(value, loc, attn, g, SHAPES, radius=RADIUS)
    want = _jax_grads(lambda v, l, a: ms_deform_attn_local(
        v, SHAPES, l, a, radius=RADIUS, interpret=True, precision=jax.lax.Precision.HIGHEST,
        min_samples=0), value, loc, attn, g)
    for name, x, y in zip(("value", "locations", "weights"), got, want):
        assert rel_err(x, y) <= TOL, name
    # the clamp bites: some coordinates get no gradient that the exact form gives one
    exact = _port_grads(value, loc, attn, g, SHAPES)[1]
    assert ((got[1] == 0) & (exact != 0)).any()


def test_extractor_form_gradients_match_jax():
    """Queries that are not the value grid (the ViT-Adapter's extractors):
    three query grids into one value level."""
    value, loc, attn, shapes = _extractor_case(seed=5)
    g = _out_grad(loc, value, 15)
    got = _port_grads(value, loc, attn, g, shapes)
    want = _jax_grads(lambda v, l, a: jax_exact(v, shapes, l, a), value, loc, attn, g)
    for name, x, y in zip(("value", "locations", "weights"), got, want):
        assert rel_err(x, y) <= TOL, name
