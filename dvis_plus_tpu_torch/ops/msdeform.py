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
  attention_weights:  (B, Lq, M, L, P) float32 or bfloat16
  returns:            (B, Lq, M*D) in ``value.dtype``, as the JAX op: sums
                      in float32, one rounding at the end

A block of the kernel takes a run of consecutive queries; the queries are
row-major grids wherever the models call this, so a run's queries are
neighbours in the image.

The kernel has two instantiations per value type (:func:`kernel_plan`): the
vector one reads 16 bytes of a head's channels per thread and needs
``D * itemsize`` to be a multiple of 16 and ``value`` to start on a 16-byte
boundary; the scalar one takes every other shape and alignment.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

MAX_LEVELS = 4  # MSDEFORM_MAX_LEVELS in csrc/msdeform_fwd.cu
SAMPLE_BYTES = 24  # MSDEFORM_SAMPLE_BYTES: shared memory per (query, head, level, point)
MAX_SMEM = 48 * 1024  # MSDEFORM_MAX_SMEM: what a block gets without asking for more
# Queries per block of 256 threads: runs of 2 were the fastest or within 6 %
# of it at every main shape on an H100 (chip_smoke.py --b1-runs; PERF.md,
# kernel B1). A run's shared memory is held to RUN_SMEM so that eight blocks
# fit an SM; with many samples a query the run is a single query.
MAX_RUN = 2
RUN_SMEM = 28672

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
    the attention weights (float32 or bfloat16, read as float32),
    accumulated in fp32 and rounded once to ``value.dtype``."""
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
    return out.transpose(1, 2).reshape(B, Lq, M * D).to(value.dtype)


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
    if min(value.shape) < 1 or min(loc.shape) < 1:
        raise ValueError(f"empty input: value {tuple(value.shape)}, locations {tuple(loc.shape)}")
    # element offsets are 32-bit, and a corner lies up to a row and a pixel on
    if B > 65535 or (Len + max(w for _, w in spatial_shapes) + 2) * M * D >= 2**31:
        raise ValueError(f"the kernel takes B <= 65535 and Len*M*D < 2^31, got {tuple(value.shape)}")
    if M * L * loc.shape[4] * SAMPLE_BYTES > MAX_SMEM:
        raise ValueError("one query's samples (M*L*P) do not fit a block's shared memory")
    if radius is not None and loc.shape[1] != Len:
        raise ValueError("the clamped form needs the queries to be the level grids (Lq == Len)")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    if loc.dtype != torch.float32:
        raise TypeError(f"sampling_locations must be float32, got {loc.dtype}")
    if attn.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention_weights must be float32 or bfloat16, got {attn.dtype}")
    for name, t in (("value", value), ("sampling_locations", loc), ("attention_weights", attn)):
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class KernelPlan(NamedTuple):
    """How one call is launched."""

    vector: bool  # the 16-byte instantiation (else the scalar one)
    queries: int  # consecutive queries a block takes


def kernel_plan(value, loc) -> KernelPlan:
    """The instantiation and the run of queries a block takes, for inputs
    that passed :func:`_check`. Plain Python on shapes and the value pointer,
    so it also runs on CPU tensors."""
    M, D = value.shape[2:]
    sample_bytes = M * loc.shape[3] * loc.shape[4] * SAMPLE_BYTES  # of one query
    vector = D * value.element_size() % 16 == 0 and value.data_ptr() % 16 == 0
    queries = 1
    while queries * 2 <= MAX_RUN and queries * 2 * sample_bytes <= RUN_SMEM:
        queries *= 2
    return KernelPlan(vector, queries)


def _launch(value, spatial_shapes, loc, attn, radius, plan: KernelPlan) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors as ``plan`` says."""
    from dvis_plus_tpu_torch.ops import _build

    global launches
    lib = _build.library()
    B, Len, M, D = value.shape
    Lq, L, P = loc.shape[1], len(spatial_shapes), loc.shape[4]
    out = torch.empty(B, Lq, M * D, dtype=value.dtype, device=value.device)
    shapes = (ctypes.c_int * (2 * L))(*[s for hw in spatial_shapes for s in hw])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msdeform_fwd(
            value.data_ptr(), int(value.dtype == torch.bfloat16),
            loc.data_ptr(), attn.data_ptr(), int(attn.dtype == torch.bfloat16), out.data_ptr(),
            B, Len, Lq, M, D, L, P, ctypes.cast(shapes, ctypes.c_void_p),
            plan.queries, int(plan.vector), -1 if radius is None else int(radius), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"msdeform_fwd launch failed: {lib.msdeform_error_string(rc).decode()}"
        )
    launches += 1
    return out


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    radius: Optional[int] = None,
) -> torch.Tensor:
    """Deformable attention forward: the CUDA kernel on CUDA tensors, the
    twin on CPU tensors. Returns (B, Lq, M*D) in ``value.dtype``."""
    spatial_shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    _check(value, spatial_shapes, sampling_locations, attention_weights, radius)
    if value.device.type == "cpu":
        return ms_deform_attn_torch(
            value, spatial_shapes, sampling_locations, attention_weights, radius
        )
    if value.device.type != "cuda":
        raise ValueError(f"no deformable-attention kernel for device {value.device}")
    return _launch(value, spatial_shapes, sampling_locations, attention_weights, radius,
                   kernel_plan(value, sampling_locations))
