"""Blockwise (flash) self-attention: the CUDA kernel's wrapper and its plain
PyTorch twin.

Counterparts: ``dvis_plus_tpu/ops/flash_attn.py::flash_self_attention`` (the
TPU library Pallas kernel, with its padding and segment ids) and the dense
``dvis_plus_tpu/models/segmenter/transformer_decoder.py::_attention`` without
a mask. Per (batch, head):

    softmax(q k^T / sqrt(Dh)) v

with fp32 scores and softmax, the probabilities rounded to v's dtype, P.V
accumulated in fp32 and the output in q's dtype.

:func:`flash_self_attention` runs the hand-written kernel
(``csrc/flash_attn_fwd.cu``) on a CUDA tensor of any length ``L >= 1`` and
the twin (:func:`attention_torch`) on a CPU tensor. On a CUDA tensor it
launches the kernel or raises; it never falls back. The kernel masks the keys
past ``L`` itself, so nothing is padded, and the JAX wrapper's dense branch
below 2048 tokens (a TPU tuning value that spares its kernel the padding to
1024) has no counterpart here. Forward only (the TPU kernel is serving-only
too).

Shapes (the JAX package's layout):
  q, k, v: (B, L, H, Dh) float32 or bfloat16; may be strided views of one
           (B, L, 3 * H * Dh) qkv output (heads and channels contiguous)
  returns: (B, L, H, Dh) in q's dtype, contiguous
"""
from __future__ import annotations

import math
from typing import Optional

import torch

HEAD_DIM = 64  # the kernel takes only this (every DINOv2 ViT has Dh = 64)

# kernel launches since the last reset (chip_smoke.py reads it to show the
# main path ran through the kernel)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: dense attention, the math of the
    JAX ``_attention`` without a mask. (B, L, H, Dh) in and out."""
    Dh = q.shape[-1]
    logits = torch.matmul(q.float().permute(0, 2, 1, 3), k.float().permute(0, 2, 3, 1))
    logits = logits / math.sqrt(Dh) if sm_scale is None else logits * sm_scale
    w = logits.softmax(dim=-1).to(v.dtype)
    return torch.matmul(w, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3).contiguous()


def _check(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, L, H, Dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must be one of float32 / bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _check_kernel_layout(q, k, v):
    """What the kernels need of q, k, v beyond :func:`_check`. The bf16
    kernel reads each through a tensor map over its (H * Dh, L, B) view: a
    16-byte aligned base, batch and row strides that are multiples of 16
    bytes and below 2^40, rows that do not overlap, no batch stride of 0
    (an expanded batch). The fp32 kernel's vector
    loads need the same alignment. Column views of one (B, L, 3 * H * Dh) qkv
    output pass; a transposed view does not."""
    B, L, H, Dh = q.shape
    if Dh != HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM}, got {Dh}")
    if B * H > 65535:
        raise ValueError(f"the kernel takes B * H <= 65535, got {B * H}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.stride(2) != Dh:
            raise ValueError(f"{name} must keep heads and channels contiguous, got strides {t.stride()}")
        size = t.element_size()
        if t.data_ptr() % 16 or (t.stride(0) * size) % 16 or (t.stride(1) * size) % 16:
            raise ValueError(f"{name} must be 16-byte aligned in its base and its batch and row strides")
        if t.stride(1) < H * Dh or t.stride(0) < 0 or max(t.stride(0), t.stride(1)) * size >= 2**40:
            raise ValueError(f"{name} must have rows that do not overlap and strides below 2^40 bytes, "
                             f"got strides {t.stride()}")
        if B > 1 and t.stride(0) == 0:
            raise ValueError(f"{name} must not repeat one batch element (batch stride 0): "
                             f"a tensor map takes no zero stride")


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention forward, (B, L, H, Dh) in and out. On CUDA bfloat16
    runs on tensor cores (``wgmma`` fed by TMA) and float32 on CUDA cores."""
    _check(q, k, v)
    B, L, H, Dh = q.shape
    if q.device.type == "cpu":
        return attention_torch(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    _check_kernel_layout(q, k, v)
    from dvis_plus_tpu_torch.ops import _build

    global launches
    lib = _build.library()
    scale = 1.0 / math.sqrt(Dh) if sm_scale is None else float(sm_scale)
    if q.dtype == torch.bfloat16 and not scale > 0.0:
        # it takes the row max of the raw scores (the float32 kernel scales first)
        raise ValueError(f"the bfloat16 kernel takes a positive sm_scale, got {scale}")
    out = torch.empty(B, L, H, Dh, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            out.data_ptr(), int(q.dtype == torch.bfloat16), B, L, H, Dh, scale, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_attn_fwd launch failed: {lib.flash_attn_error_string(rc).decode()}"
        )
    launches += 1
    return out
