"""Swin window attention: the CUDA kernel's wrapper and its plain PyTorch twin.

Counterparts: ``dvis_plus_tpu/ops/swin_window_attn.py`` (the TPU Pallas
kernel ``_kernel`` driven by ``fused_window_attention``, and its oracle
``window_attention_reference``) and the default fp32-softmax path of
``dvis_plus_tpu/models/backbones/swin.py::WindowAttention`` (:134-145).
Per (window, head):

    softmax(q k^T * Dh^-0.5 + bias[h] [+ mask[window % nW]]) v

with the scores, the bias and mask adds and the softmax in fp32; the
probabilities are rounded to v's dtype, P.V accumulates in fp32 and is
written in q's dtype. The JAX default path and its fused Pallas path compute
this same math (the Pallas kernel casts bias and mask to q's dtype first,
which only matters in bf16; here both are added in fp32, as the default path
does), so one kernel serves both values of ``backbone.swin_fused_attn``; it serves
both values of ``backbone.swin_fast_softmax`` too, as the fused kernel wins
over the bf16-score path in the JAX module where it runs (:97-106). The CPU
twin of the bf16-score path is :func:`window_attention_fast_softmax_torch`.
(The bf16 CUDA kernel rounds ``exp(x - max)`` to bf16 for the product and
divides the fp32 result by the fp32 row sum, instead of rounding the
normalised probabilities: the same relative rounding of p, within one bf16
ulp of the output of this definition.)

On a CPU tensor :func:`window_attention` computes the twin
:func:`window_attention_torch`. On a CUDA tensor it launches the
hand-written kernel (``csrc/swin_window_attn_fwd.cu``: tensor cores with the
head's bias kept in shared memory for bfloat16, CUDA cores for float32) or
raises; it never falls back. Forward only (the TPU kernel has no VJP
either): on a CUDA tensor it raises ``NotImplementedError`` when gradients
are enabled and an input requires one. The Swin module in training mode
calls :func:`window_attention_torch` itself.

Shapes (the JAX package's layout, heads as column slices of C):
  q, k, v: (B_, N, C) float32 or bfloat16, B_ batch-major over windows
           (B * nW); may be strided views of one (B_, N, 3C) qkv output
           (last dim contiguous)
  bias:    (H, N, N) float32 relative-position bias
  mask:    (nW, N, N) float32 shifted-window mask, or None
  returns: (B_, N, C) in q's dtype
"""
from __future__ import annotations

from typing import Optional

import torch

HEAD_DIM = 32  # Dh of every Swin variant; the kernels take only this
SMEM_LIMIT = 48 * 1024  # static shared memory of one block of the fp32 kernel
# it stages K in fp32 with a padded row of Dh + 1 words, V in fp32 rows of Dh
SMEM_PER_KEY = (2 * HEAD_DIM + 1) * 4
# 189 tokens per window (ws <= 13); the bf16 kernel's shared memory (the
# head's bias beside one q/k/v stage) holds that many too
MAX_TOKENS = SMEM_LIMIT // SMEM_PER_KEY

# kernel launches since the last reset (chip_smoke.py reads it to show the
# main path ran through the kernel)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def window_attention_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel (``window_attention_reference``)."""
    B_, N, C = q.shape
    H = num_heads
    Dh = C // H

    def heads(x):
        return x.reshape(B_, N, H, Dh).transpose(1, 2).float()  # (B_, H, N, Dh)

    attn = torch.matmul(heads(q), heads(k).transpose(-1, -2))
    attn = attn * (Dh ** -0.5) + bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.reshape(B_ // nW, nW, H, N, N) + mask.float()[None, :, None]
        attn = attn.reshape(B_, H, N, N)
    p = attn.softmax(dim=-1).to(v.dtype).float()
    out = torch.matmul(p, heads(v)).to(q.dtype)  # fp32 accumulation
    return out.transpose(1, 2).reshape(B_, N, C)


def window_attention_fast_softmax_torch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
) -> torch.Tensor:
    """The ``backbone.swin_fast_softmax`` form for bfloat16 inputs (the JAX
    ``WindowAttention`` bf16-score path, ``models/backbones/swin.py:111-126``):
    the q.k product, the scale, the bias and mask adds, the max subtraction
    and the exp in bfloat16, the row sum in fp32, the probabilities
    ``e * (1 / sum)`` rounded to bfloat16, and P.V in bfloat16. Another dtype
    takes :func:`window_attention_torch`, as the JAX path engages on bf16
    alone."""
    if q.dtype != torch.bfloat16:
        return window_attention_torch(q, k, v, bias, mask, num_heads)
    B_, N, C = q.shape
    H = num_heads
    Dh = C // H

    def heads(x):
        return x.reshape(B_, N, H, Dh).transpose(1, 2)  # (B_, H, N, Dh)

    bf = torch.bfloat16
    attn = torch.matmul(heads(q), heads(k).transpose(-1, -2))
    attn = attn * torch.tensor(Dh ** -0.5, dtype=bf) + bias.to(bf)[None]
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.reshape(B_ // nW, nW, H, N, N) + mask.to(bf)[None, :, None]
        attn = attn.reshape(B_, H, N, N)
    e = torch.exp(attn - attn.amax(dim=-1, keepdim=True))
    s = e.sum(dim=-1, keepdim=True, dtype=torch.float32)
    p = e * (1.0 / s).to(bf)
    return torch.matmul(p, heads(v)).transpose(1, 2).reshape(B_, N, C)


def _check(q, k, v, bias, mask, num_heads):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B_, N, C) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B_, N, C = q.shape
    if C != num_heads * HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM}, got C={C} with {num_heads} heads")
    if N > MAX_TOKENS:
        raise ValueError(f"the kernel takes at most {MAX_TOKENS} tokens per window, got {N}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must be one of float32 / bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(bias.shape) != (num_heads, N, N) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32 ({num_heads}, {N}, {N}), got {bias.dtype} {tuple(bias.shape)}")
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (N, N) or mask.dtype != torch.float32:
            raise ValueError(f"mask must be float32 (nW, {N}, {N}), got {mask.dtype} {tuple(mask.shape)}")
        if B_ % mask.shape[0]:
            raise ValueError(f"B_={B_} is not a multiple of nW={mask.shape[0]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1:
            raise ValueError(f"{name} must have a contiguous last dim")
    for name, t in (("k", k), ("v", v), ("bias", bias), ("mask", mask)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("bias", bias), ("mask", mask)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_kernel_layout(q, k, v, bias, mask):
    """What the bf16 kernel's vector copies need beyond :func:`_check`. Of
    q, k, v: a 16-byte aligned base and window and row strides that are
    multiples of 16 bytes. Column views of one (B_, N, 3C) qkv output pass; a
    view that starts or strides half a chunk off does not. Of the bias, which
    is copied 16 bytes at a time where its rows allow it (N % 4 == 0), a
    16-byte aligned base there; of the mask, read 8 bytes at a time where N
    is even, an 8-byte aligned base there. (The fp32 kernel reads element by
    element and takes whatever :func:`_check` takes.)"""
    N = q.shape[1]
    for name, t, align in (("bias", bias, 16 if N % 4 == 0 else 4), ("mask", mask, 8 if N % 2 == 0 else 4)):
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned for N={N}, got offset {t.data_ptr() % align}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        size = t.element_size()
        if t.data_ptr() % 16 or (t.stride(0) * size) % 16 or (t.stride(1) * size) % 16:
            raise ValueError(
                f"{name} must be 16-byte aligned in its base and its window and row strides, "
                f"got offset {t.data_ptr() % 16} and strides {t.stride()}")
        if t.stride(0) < 0 or t.stride(1) < 0:
            raise ValueError(f"{name} must have non-negative strides, got {t.stride()}")


def window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    mask: Optional[torch.Tensor],
    num_heads: int,
    fast_softmax: bool = False,
) -> torch.Tensor:
    """Window attention forward: the CUDA kernel on CUDA tensors, the twin on
    CPU tensors (with ``fast_softmax`` its bf16-score form,
    :func:`window_attention_fast_softmax_torch`). The kernel serves both
    values of ``fast_softmax``, as the JAX fused kernel takes precedence
    over the bf16-score path where it runs (``swin.py:97-106``). Returns
    (B_, N, C) in q's dtype."""
    _check(q, k, v, bias, mask, num_heads)
    if q.device.type == "cpu":
        plain = window_attention_fast_softmax_torch if fast_softmax else window_attention_torch
        return plain(q, k, v, bias, mask, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"no window-attention kernel for device {q.device}")
    from dvis_plus_tpu_torch.ops import _build

    _build.refuse_grad("swin_window_attn_fwd", "a Swin module in training mode takes the plain "
                       "op, as the JAX package trains with swin_fused_attn off", q, k, v, bias)
    if q.dtype == torch.bfloat16:
        _check_kernel_layout(q, k, v, bias, mask)

    global launches
    lib = _build.library()
    B_, N, C = q.shape
    out = torch.empty(B_, N, C, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.swin_window_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            bias.data_ptr(), 0 if mask is None else mask.data_ptr(),
            0 if mask is None else mask.shape[0], out.data_ptr(),
            int(q.dtype == torch.bfloat16), B_, N, num_heads, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"swin_window_attn_fwd launch failed: {lib.swin_window_attn_error_string(rc).decode()}"
        )
    launches += 1
    return out
