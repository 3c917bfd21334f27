"""The port's deformable-attention op (twin and wrapper) against the JAX ops.

On the CPU the wrapper computes the plain PyTorch twin; the CUDA kernel is
held against the twin by ``tests/test_torch_cuda.py`` (skipped without a
card) and by ``chip_smoke.py``. Tolerances: fp32 rel <= 1e-5 (reduction-order noise);
bf16 values rel <= 2e-2 against JAX, which rounds the weights and the
accumulator to bf16 where the port accumulates in fp32 (8 mantissa bits:
~4e-3 per rounding, a few roundings per output).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.ops.msdeform import ms_deform_attn as jax_exact
from dvis_plus_tpu.ops.msdeform import ms_deform_attn_reference as jax_reference
from dvis_plus_tpu.ops.msdeform_pallas import _local_exact_oracle, ms_deform_attn_local
from dvis_plus_tpu_torch.ops import msdeform
from tests.test_torch_common import rel_err

torch.set_num_threads(2)

SHAPES = [(8, 8), (4, 4), (2, 2)]
RADIUS = 3
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _case(seed=0, B=1, M=2, D=8, P=4, spread=6.0):
    """Encoder-style queries (the level grids) with offsets up to ``spread``
    value-level pixels: locations inside, on the border of and outside
    [0, 1], many beyond RADIUS."""
    rng = np.random.RandomState(seed)
    Len = sum(h * w for h, w in SHAPES)
    value = rng.randn(B, Len, M, D).astype(np.float32)
    refs = []
    for H, W in SHAPES:
        qi = (np.arange(H * W) // W + 0.5) / H
        qj = (np.arange(H * W) % W + 0.5) / W
        refs.append(np.stack([qj, qi], -1))
    ref = np.concatenate(refs, 0)
    loc = np.zeros((B, Len, M, len(SHAPES), P, 2), np.float32)
    for lv, (H, W) in enumerate(SHAPES):
        off = rng.uniform(-spread, spread, (B, Len, M, P, 2)).astype(np.float32)
        loc[:, :, :, lv] = ref[None, :, None, None] + off / np.array([W, H])
    loc[0, 0, 0, 0, 0] = (0.0, 1.0)  # exactly on the border
    loc[0, 1, 0, 0, 0] = (1.0 + 0.5 / SHAPES[0][1], 0.5)  # half a pixel outside
    attn = rng.rand(B, Len, M, len(SHAPES), P).astype(np.float32)
    attn /= attn.sum((-1, -2), keepdims=True)
    return value, loc, attn


def _port(value, loc, attn, dtype, radius=None):
    v = torch.from_numpy(value).to(getattr(torch, dtype))
    return msdeform.ms_deform_attn(
        v, SHAPES, torch.from_numpy(loc), torch.from_numpy(attn), radius=radius
    ).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_form_matches_jax(dtype):
    value, loc, attn = _case(seed=1)
    assert (loc < 0).any() and (loc > 1).any()
    got = _port(value, loc, attn, dtype)
    v = jnp.asarray(value).astype(dtype)
    for fn in (jax_exact, jax_reference):
        want = fn(v, SHAPES, jnp.asarray(loc), jnp.asarray(attn)).astype(jnp.float32)
        assert rel_err(got, want) <= TOL[dtype], fn.__name__


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clamped_form_matches_oracle(dtype):
    value, loc, attn = _case(seed=2)
    got = _port(value, loc, attn, dtype, radius=RADIUS)
    want = _local_exact_oracle(
        jnp.asarray(value).astype(dtype), SHAPES, jnp.asarray(loc), jnp.asarray(attn), RADIUS
    ).astype(jnp.float32)
    assert rel_err(got, want) <= TOL[dtype]
    # the clamp bites: the unclamped result differs
    assert rel_err(_port(value, loc, attn, dtype), want) > 10 * TOL[dtype]


def test_clamped_form_matches_pallas_kernel_interpret():
    """Against the TPU kernel itself, run in interpret mode at full fp32
    precision on every (query level, value level) pair it takes."""
    value, loc, attn = _case(seed=3, M=2, D=8, P=2, spread=4.0)
    want = ms_deform_attn_local(
        jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(attn), radius=RADIUS,
        interpret=True, precision=jax.lax.Precision.HIGHEST, min_samples=0,
    )
    assert rel_err(_port(value, loc, attn, "float32", radius=RADIUS), want) <= 1e-5


def test_cpu_wrapper_runs_the_twin_and_counts_no_launch():
    value, loc, attn = _case(seed=4)
    msdeform.reset_launches()
    got = _port(value, loc, attn, "float32", radius=RADIUS)
    twin = msdeform.ms_deform_attn_torch(
        torch.from_numpy(value), SHAPES, torch.from_numpy(loc), torch.from_numpy(attn), RADIUS
    ).numpy()
    np.testing.assert_array_equal(got, twin)
    assert msdeform.launches == 0


@pytest.mark.parametrize(
    "bad",
    ["value_dtype", "loc_dtype", "shapes", "noncontiguous", "radius_needs_grid"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    value, loc, attn = (torch.from_numpy(x) for x in _case(seed=5))
    shapes = SHAPES
    radius = None
    if bad == "value_dtype":
        value = value.double()
    elif bad == "loc_dtype":
        loc = loc.half()
    elif bad == "shapes":
        shapes = SHAPES[:2]
    elif bad == "noncontiguous":
        value = value.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        loc, attn, radius = loc[:, :10].contiguous(), attn[:, :10].contiguous(), RADIUS
    with pytest.raises((ValueError, TypeError)):
        msdeform.ms_deform_attn(value, shapes, loc, attn, radius=radius)
