"""Kernel B2's plain PyTorch twin against the JAX window attention: the XLA
oracle ``window_attention_reference`` and the Pallas kernel
``fused_window_attention`` in interpret mode, on the same seeded inputs.

fp32: rel <= 1e-5. bf16 inputs against the fp32 oracle: max abs <= 5e-2,
the JAX test's own bound (``tests/test_swin_fused_attn.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.ops.swin_window_attn import (
    fused_window_attention,
    window_attention_reference,
)
from dvis_plus_tpu_torch.ops import swin_window_attn as b2
from tests.test_torch_common import rel_err

torch.set_num_threads(2)

CASES = [  # B_, N, H, nW (0 = no mask)
    (8, 144, 2, 0),
    (8, 144, 2, 4),
    (6, 49, 3, 0),
    (6, 49, 3, 3),
]


def _inputs(B_, N, H, nW, seed=0):
    rng = np.random.RandomState(seed)
    C = H * 32
    q = (0.5 * rng.randn(B_, N, C)).astype(np.float32)
    k = (0.5 * rng.randn(B_, N, C)).astype(np.float32)
    v = rng.randn(B_, N, C).astype(np.float32)
    bias = (0.1 * rng.randn(H, N, N)).astype(np.float32)
    mask = None
    if nW:
        ids = rng.randint(0, 3, (nW, N))
        mask = np.where(ids[:, None, :] != ids[:, :, None], -100.0, 0.0).astype(np.float32)
    return q, k, v, bias, mask


def _jax(fn, q, k, v, bias, mask, H, **kw):
    m = None if mask is None else jnp.asarray(mask)
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), m, H, **kw))


def _port(q, k, v, bias, mask, H, dtype=torch.float32):
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    return b2.window_attention(
        t(q).to(dtype), t(k).to(dtype), t(v).to(dtype), t(bias),
        None if mask is None else t(mask), H,
    ).float().numpy()


@pytest.mark.parametrize("B_,N,H,nW", CASES)
def test_twin_matches_jax_reference_and_pallas_kernel(B_, N, H, nW):
    q, k, v, bias, mask = _inputs(B_, N, H, nW)
    got = _port(q, k, v, bias, mask, H)
    assert rel_err(got, _jax(window_attention_reference, q, k, v, bias, mask, H)) <= 1e-5
    pallas = _jax(fused_window_attention, q, k, v, bias, mask, H, interpret=True)
    assert rel_err(got, pallas) <= 1e-5


@pytest.mark.parametrize("N", [144, 49])
def test_twin_bf16_close_to_fp32_oracle(N):
    q, k, v, bias, mask = _inputs(8, N, 2, 4, seed=1)
    want = _jax(window_attention_reference, q, k, v, bias, mask, 2)
    got = _port(q, k, v, bias, mask, 2, dtype=torch.bfloat16)
    assert np.abs(got - want).max() < 5e-2


def test_strided_qkv_views_equal_contiguous():
    """q/k/v as column views of one (B_, N, 3C) qkv output, as the Swin
    block passes them."""
    q, k, v, bias, mask = _inputs(4, 144, 2, 2, seed=2)
    qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1))
    views = qkv.split(q.shape[-1], dim=-1)
    assert views[0].stride(1) == 3 * q.shape[-1]
    got = b2.window_attention(*views, torch.from_numpy(bias), torch.from_numpy(mask), 2)
    np.testing.assert_array_equal(got.numpy(), _port(q, k, v, bias, mask, 2))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, bias, mask = (torch.from_numpy(x) for x in _inputs(4, 49, 2, 2))
    with pytest.raises(ValueError):  # head dim 16
        b2.window_attention(q, k, v, bias, mask, 4)
    with pytest.raises(ValueError):  # B_ not a multiple of nW
        b2.window_attention(q[:3], k[:3], v[:3], bias, mask, 2)
    with pytest.raises(TypeError):
        b2.window_attention(q.half(), k.half(), v.half(), bias, mask, 2)
    with pytest.raises(ValueError):  # bias not fp32
        b2.window_attention(q, k, v, bias.double(), mask, 2)
    assert b2.launches == 0  # the CPU path never counts a launch
