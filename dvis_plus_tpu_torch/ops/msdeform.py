"""Multi-scale deformable attention: the CUDA kernel's wrapper and its plain
PyTorch twin.

Counterparts: ``dvis_plus_tpu/ops/msdeform.py::ms_deform_attn`` (exact form)
and ``dvis_plus_tpu/ops/msdeform_pallas.py::ms_deform_attn_local`` /
``_local_exact_oracle`` (radius-clamped form, the TPU Pallas kernel
``_window_kernel``). :func:`ms_deform_attn` takes ``radius=None`` for the
exact form and an integer radius for the clamped one.

On a CPU tensor the wrapper computes the twin :func:`ms_deform_attn_torch`.
On a CUDA tensor it launches the hand-written kernel
(``csrc/msdeform_fwd.cu``) or raises; it never falls back. Forward only: the
backward comes with training, so the model calls this under
``torch.no_grad()``/``torch.inference_mode()``.

Shapes (the JAX package's layout):
  value:              (B, Len, M, D) float32 or bfloat16
  spatial_shapes:     ((H_0, W_0), ..., (H_{L-1}, W_{L-1})), sum H*W == Len
  sampling_locations: (B, Lq, M, L, P, 2) float32, normalized (x, y)
  attention_weights:  (B, Lq, M, L, P) float32
  returns:            (B, Lq, M*D) float32
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

MAX_LEVELS = 4  # MSDEFORM_MAX_LEVELS in csrc/msdeform_fwd.cu

# kernel launches since the last reset (chip_smoke.py reads it to show the
# main path ran through the kernel)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def clamp_locations(
    sampling_locations: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    radius: int,
) -> torch.Tensor:
    """Clamp each location to +-``radius`` value-level pixels around its
    query's pixel-centre reference point and return normalized locations
    (``_local_exact_oracle``'s clamp, per (query level, value level) pair).
    Queries must be the concatenated level grids."""
    Lq = sampling_locations.shape[1]
    dev = sampling_locations.device
    out = []
    start = 0
    for Hq, Wq in spatial_shapes:
        n = Hq * Wq
        loc_q = sampling_locations[:, start : start + n].float()
        start += n
        qi = (torch.arange(n, device=dev) // Wq).float()
        qj = (torch.arange(n, device=dev) % Wq).float()
        per_level = []
        for lv, (Hv, Wv) in enumerate(spatial_shapes):
            x = loc_q[..., lv, :, 0] * Wv - 0.5
            y = loc_q[..., lv, :, 1] * Hv - 0.5
            ref_y = ((qi + 0.5) * (Hv / Hq))[None, :, None, None]
            ref_x = ((qj + 0.5) * (Wv / Wq))[None, :, None, None]
            y = torch.minimum(torch.maximum(y, ref_y - radius), ref_y + radius)
            x = torch.minimum(torch.maximum(x, ref_x - radius), ref_x + radius)
            per_level.append(torch.stack([(x + 0.5) / Wv, (y + 0.5) / Hv], dim=-1))
        out.append(torch.stack(per_level, dim=3))
    if start != Lq:
        raise ValueError(f"clamped form needs Lq == Len (queries are the level grids), got {Lq} != {start}")
    return torch.cat(out, dim=1).to(sampling_locations.dtype)


def ms_deform_attn_torch(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    radius: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: per level, an explicit gather of the
    four bilinear corners (zero padding, align_corners=False), weighted by
    the attention weights, accumulated in fp32."""
    B, _, M, D = value.shape
    Lq, P = sampling_locations.shape[1], sampling_locations.shape[4]
    if radius is not None:
        sampling_locations = clamp_locations(sampling_locations, spatial_shapes, radius)
    v = value.float().transpose(1, 2)  # (B, M, Len, D)
    out = torch.zeros(B, M, Lq, D, dtype=torch.float32, device=value.device)
    start = 0
    for lid, (H, W) in enumerate(spatial_shapes):
        v_l = v[:, :, start : start + H * W]  # (B, M, HW, D)
        start += H * W
        loc = sampling_locations[:, :, :, lid].float().transpose(1, 2)  # (B, M, Lq, P, 2)
        a = attention_weights[:, :, :, lid].float().transpose(1, 2)  # (B, M, Lq, P)
        x = loc[..., 0] * W - 0.5
        y = loc[..., 1] * H - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        wx1 = x - x0
        wy1 = y - y0
        corners = (
            (y0, x0, (1.0 - wy1) * (1.0 - wx1)),
            (y0, x0 + 1.0, (1.0 - wy1) * wx1),
            (y0 + 1.0, x0, wy1 * (1.0 - wx1)),
            (y0 + 1.0, x0 + 1.0, wy1 * wx1),
        )
        for yc, xc, w in corners:
            valid = (xc >= 0) & (xc < W) & (yc >= 0) & (yc < H)
            idx = (yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)).long()  # (B, M, Lq, P)
            g = torch.gather(
                v_l, 2, idx.reshape(B, M, Lq * P, 1).expand(B, M, Lq * P, D)
            ).reshape(B, M, Lq, P, D)
            wt = (w * valid.float() * a).unsqueeze(-1)
            out += (g * wt).sum(dim=3)
    return out.transpose(1, 2).reshape(B, Lq, M * D)


def _check(value, spatial_shapes, loc, attn, radius):
    if value.dim() != 4:
        raise ValueError(f"value must be (B, Len, M, D), got {tuple(value.shape)}")
    B, Len, M, D = value.shape
    L = len(spatial_shapes)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"the kernel takes 1..{MAX_LEVELS} levels, got {L}")
    if sum(h * w for h, w in spatial_shapes) != Len:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not cover Len={Len}")
    if loc.dim() != 6 or loc.shape[0] != B or loc.shape[2:4] != (M, L) or loc.shape[5] != 2:
        raise ValueError(f"sampling_locations must be (B, Lq, M, L, P, 2), got {tuple(loc.shape)}")
    if tuple(attn.shape) != tuple(loc.shape[:5]):
        raise ValueError(f"attention_weights must be {tuple(loc.shape[:5])}, got {tuple(attn.shape)}")
    if M * D > 1024:
        raise ValueError(f"the kernel takes M*D <= 1024 channels, got {M * D}")
    if radius is not None and loc.shape[1] != Len:
        raise ValueError("the clamped form needs the queries to be the level grids (Lq == Len)")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    if loc.dtype != torch.float32 or attn.dtype != torch.float32:
        raise TypeError("sampling_locations and attention_weights must be float32")
    for name, t in (("value", value), ("sampling_locations", loc), ("attention_weights", attn)):
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    radius: Optional[int] = None,
) -> torch.Tensor:
    """Deformable attention forward: the CUDA kernel on CUDA tensors, the
    twin on CPU tensors. Returns (B, Lq, M*D) float32."""
    spatial_shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    _check(value, spatial_shapes, sampling_locations, attention_weights, radius)
    if value.device.type == "cpu":
        return ms_deform_attn_torch(
            value, spatial_shapes, sampling_locations, attention_weights, radius
        )
    if value.device.type != "cuda":
        raise ValueError(f"no deformable-attention kernel for device {value.device}")
    from dvis_plus_tpu_torch.ops import _build

    global launches
    lib = _build.library()
    B, Len, M, D = value.shape
    Lq, L, P = sampling_locations.shape[1], len(spatial_shapes), sampling_locations.shape[4]
    out = torch.empty(B, Lq, M * D, dtype=torch.float32, device=value.device)
    shapes = (ctypes.c_int * (2 * L))(*[s for hw in spatial_shapes for s in hw])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msdeform_fwd(
            value.data_ptr(), int(value.dtype == torch.bfloat16),
            sampling_locations.data_ptr(), attention_weights.data_ptr(), out.data_ptr(),
            B, Len, Lq, M, D, L, P, ctypes.cast(shapes, ctypes.c_void_p),
            -1 if radius is None else int(radius), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"msdeform_fwd launch failed: {lib.msdeform_error_string(rc).decode()}"
        )
    launches += 1
    return out
