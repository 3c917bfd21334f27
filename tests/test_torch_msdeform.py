"""The port's deformable-attention op (twin and wrapper) against the JAX ops.

On the CPU the wrapper computes the plain PyTorch twin; the CUDA kernel is
held against the twin by ``tests/test_torch_cuda.py`` (skipped without a
card) and by ``chip_smoke.py``. Both packages return ``value.dtype``.
Tolerances: fp32 rel <= 1e-5 (reduction-order noise);
bf16 values rel <= 2e-2 against JAX, which rounds the weights and the
accumulator to bf16 where the port accumulates in fp32 and rounds once at
the end (8 mantissa bits: ~4e-3 per rounding, a few roundings per output).
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


def _port(value, loc, attn, dtype, radius=None, shapes=SHAPES, attn_dtype=torch.float32):
    """The wrapper's result as float32 numpy, held to ``value.dtype`` first."""
    v = torch.from_numpy(value).to(getattr(torch, dtype))
    out = msdeform.ms_deform_attn(
        v, shapes, torch.from_numpy(loc), torch.from_numpy(attn).to(attn_dtype), radius=radius
    )
    assert out.dtype == v.dtype and out.shape == (*loc.shape[:2], value.shape[2] * value.shape[3])
    return out.float().numpy()


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


def _extractor_case(seed, B=2, M=4, D=8, P=4, grid=(5, 7)):
    """The ViT-Adapter extractor's form, small: three query grids (2x, 1x and
    half the value grid) attend into one value level, so ``Lq != Len``."""
    rng = np.random.RandomState(seed)
    H, W = grid
    qgrids = [(2 * H, 2 * W), (H, W), (H // 2, W // 2)]
    Lq = sum(h * w for h, w in qgrids)
    value = rng.randn(B, H * W, M, D).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (B, Lq, M, 1, P, 2)).astype(np.float32)
    attn = rng.rand(B, Lq, M, 1, P).astype(np.float32)
    attn /= attn.sum((-1, -2), keepdims=True)
    return value, loc, attn, [grid]


@pytest.mark.parametrize("grid", [(5, 7), (4, 1)], ids=["5x7", "one_pixel_wide"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extractor_form_matches_jax(dtype, grid):
    """``Lq != Len`` and one level."""
    value, loc, attn, shapes = _extractor_case(seed=6, grid=grid)
    assert loc.shape[1] != value.shape[1]
    got = _port(value, loc, attn, dtype, shapes=shapes)
    v = jnp.asarray(value).astype(dtype)
    for fn in (jax_exact, jax_reference):
        want = fn(v, shapes, jnp.asarray(loc), jnp.asarray(attn)).astype(jnp.float32)
        assert rel_err(got, want) <= TOL[dtype], fn.__name__


@pytest.mark.parametrize("form", ["exact", "clamped", "extractor"])
def test_bfloat16_attention_weights_are_read_as_float32(form):
    """The kernel and its twin take bfloat16 weights (the extractor's softmax
    in a bfloat16 model) and read them as float32: the result equals the
    float32 call on the rounded weights, and the JAX op's on them."""
    if form == "extractor":
        value, loc, attn, shapes = _extractor_case(seed=7)
        radius = None
    else:
        value, loc, attn = _case(seed=7)
        shapes, radius = SHAPES, RADIUS if form == "clamped" else None
    rounded = torch.from_numpy(attn).bfloat16().float().numpy()
    assert (rounded != attn).any()
    got = _port(value, loc, attn, "float32", radius, shapes, attn_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got, _port(value, loc, rounded, "float32", radius, shapes))
    args = (jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(rounded))
    want = jax_exact(*args) if radius is None else _local_exact_oracle(*args, radius)
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_wrapper_runs_the_twin_and_counts_no_launch(dtype):
    value, loc, attn = _case(seed=4)
    msdeform.reset_launches()
    got = _port(value, loc, attn, dtype, radius=RADIUS)
    twin = msdeform.ms_deform_attn_torch(
        torch.from_numpy(value).to(getattr(torch, dtype)), SHAPES, torch.from_numpy(loc),
        torch.from_numpy(attn), RADIUS
    )
    assert twin.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got, twin.float().numpy())
    assert msdeform.launches == 0


def test_twin_rounds_once_from_float32_sums():
    """The bfloat16 result is the float32-accumulated result of the same
    bfloat16 values, rounded once."""
    value, loc, attn = _case(seed=8)
    v16 = torch.from_numpy(value).bfloat16()
    args = (SHAPES, torch.from_numpy(loc), torch.from_numpy(attn))
    np.testing.assert_array_equal(
        msdeform.ms_deform_attn_torch(v16, *args).float().numpy(),
        msdeform.ms_deform_attn_torch(v16.float(), *args).bfloat16().float().numpy(),
    )


@pytest.mark.parametrize(
    "bad",
    ["value_dtype", "loc_dtype", "attn_dtype", "shapes", "noncontiguous", "radius_needs_grid",
     "empty_queries", "too_many_samples", "five_levels"],
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
    elif bad == "attn_dtype":
        attn = attn.half()
    elif bad == "empty_queries":
        loc, attn = loc[:, :0].contiguous(), attn[:, :0].contiguous()
    elif bad == "too_many_samples":  # one query's samples exceed a block's shared memory
        P = msdeform.MAX_SMEM // (msdeform.SAMPLE_BYTES * value.shape[2] * len(SHAPES)) + 1
        loc = torch.zeros(1, 1, value.shape[2], len(SHAPES), P, 2)
        attn = torch.zeros(1, 1, value.shape[2], len(SHAPES), P)
        value = value[:1].contiguous()
    elif bad == "five_levels":
        shapes = [(8, 8), (4, 4), (1, 1), (1, 1), (1, 2)]
        loc, attn = torch.zeros(1, 84, 2, 5, 4, 2), torch.zeros(1, 84, 2, 5, 4)
    else:
        loc, attn, radius = loc[:, :10].contiguous(), attn[:, :10].contiguous(), RADIUS
    with pytest.raises((ValueError, TypeError)):
        msdeform.ms_deform_attn(value, shapes, loc, attn, radius=radius)
