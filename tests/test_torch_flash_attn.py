"""The port's attention core (the plain version of kernel B3) against the JAX
package's dense ``_attention`` and its ``flash_self_attention`` wrapper (on
the CPU that wrapper takes its dense fallback, as in ``test_flash_attn.py``).

Tolerances: fp32 rel <= 1e-5 of the output's max (sums in different orders);
bf16 abs <= 2e-2 against the fp32 result (p and the output round to bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.models.segmenter.transformer_decoder import _attention
from dvis_plus_tpu.ops.flash_attn import _MIN_FLASH_TOKENS as JAX_MIN_FLASH_TOKENS
from dvis_plus_tpu.ops.flash_attn import flash_self_attention as jax_flash_self_attention
from dvis_plus_tpu_torch.ops import flash_attn
from tests.test_torch_common import rel_err

torch.set_num_threads(2)


def _qkv(L, B=1, H=2, Dh=64, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, L, H, Dh).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("L", [2304, 65])
@pytest.mark.parametrize("jax_fn", [_attention, jax_flash_self_attention], ids=["dense", "flash"])
def test_attention_torch_matches_jax_fp32(L, jax_fn):
    q, k, v = _qkv(L)
    want = np.asarray(jax_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = flash_attn.attention_torch(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == want.shape == (1, L, 2, 64) and got.is_contiguous()
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("L", [2304, 65])
def test_attention_torch_bf16_close_to_fp32(L):
    q, k, v = _qkv(L, seed=1)
    want = np.asarray(_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = flash_attn.attention_torch(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2e-2


def test_sm_scale_and_strided_views():
    """q, k, v as column views of one fused (B, L, 3C) tensor, as the ViT
    trunk hands them over, and an explicit scale."""
    rng = np.random.RandomState(2)
    B, L, H, Dh = 2, 50, 2, 64
    qkv = torch.from_numpy(rng.randn(B, L, 3 * H * Dh).astype(np.float32))
    q, k, v = (t.unflatten(-1, (H, Dh)) for t in qkv.split(H * Dh, dim=-1))
    assert not q.is_contiguous()
    got = flash_attn.flash_self_attention(q, k, v, sm_scale=0.2)
    want = flash_attn.attention_torch(q.contiguous(), k.contiguous(), v.contiguous(), 0.2)
    assert torch.equal(got, want)
    ref = torch.einsum("bqhd,bkhd->bhqk", q, k).mul(0.2).softmax(-1)
    assert rel_err(got, torch.einsum("bhqk,bkhd->bqhd", ref, v)) <= 1e-5


def test_wrapper_threshold_and_cpu_path(monkeypatch):
    """A CPU tensor takes the plain version at any length, on either side of
    the JAX wrapper's dense threshold, and nothing is launched. The port has
    no threshold of its own: the device alone picks the route."""
    assert JAX_MIN_FLASH_TOKENS == 2048 and not hasattr(flash_attn, "_MIN_FLASH_TOKENS")
    calls = []
    real = flash_attn.attention_torch
    monkeypatch.setattr(flash_attn, "attention_torch", lambda *a: calls.append(a[0].shape[1]) or real(*a))
    flash_attn.reset_launches()
    for L in (2047, 2048):
        q, k, v = map(torch.from_numpy, _qkv(L, H=1, seed=3))
        out = flash_attn.flash_self_attention(q, k, v)
        assert out.shape == (1, L, 1, 64)
    assert calls == [2047, 2048] and flash_attn.launches == 0


def test_wrapper_checks_its_inputs():
    q, k, v = map(torch.from_numpy, _qkv(8))
    with pytest.raises(ValueError):
        flash_attn.flash_self_attention(q, k[:, :4], v)
    with pytest.raises(TypeError):
        flash_attn.flash_self_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attn.flash_self_attention(q, k.bfloat16(), v)
