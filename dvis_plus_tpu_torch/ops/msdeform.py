"""Multi-scale deformable attention: the CUDA kernel's wrapper and its plain
PyTorch twin.

Counterparts: ``dvis_plus_tpu/ops/msdeform.py::ms_deform_attn`` (exact form)
and ``dvis_plus_tpu/ops/msdeform_pallas.py::ms_deform_attn_local`` /
``_local_exact_oracle`` (radius-clamped form, the TPU Pallas kernel
``_window_kernel``). :func:`ms_deform_attn` takes ``radius=None`` for the
exact form and an integer radius for the clamped one.

On a CPU tensor the wrapper computes the twin :func:`ms_deform_attn_torch`,
whose gradient is autograd's. On a CUDA tensor it launches the hand-written
kernel (``csrc/msdeform_fwd.cu``) or raises; it never falls back. When
gradients are enabled and an input requires one, the call is a
``torch.autograd.Function`` (:class:`_MSDeformAttn`) that saves its inputs
and whose backward launches the backward kernels (``csrc/msdeform_bwd.cu``):
the gradients of the value, the locations and the weights, for both forms.
The JAX package has no backward TPU kernel (it differentiates the plain
forms through XLA), so they are held against autograd of the twin.

A backward call is 2 + L launches (:func:`backward_plan` sets them up):
one gather for the locations' and weights' gradients, shaped as the forward
(a run of queries a block, 16 bytes of a head a thread); one counting sort
of every (batch element, head, level)'s samples by the cell of their
corners; then, a launch a value level, the value's gradient summed a cell at
a time in registers into a band of the level's rows held in shared memory,
written once, rounded to ``value.dtype``: no atomics on floats, no zero
fill, no rounding pass.

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
MAX_BACKWARD_D = 256
# csrc/msdeform_bwd.cu's value gradient: a block of the sort kernel keeps a
# level's cell counts ((H + 1) * (W + 1) + 1 ints) in shared memory, and a
# block of the value-gradient kernel a band of a level's rows, all D channels
# of a head in fp32; each within VALUE_SMEM bytes (an H100 block's 232,448
# less a kilobyte for static shared memory)
VALUE_SMEM = 232448 - 1024

# launches of the forward and of the backward kernel since the last reset
# (chip_smoke.py reads them to show the main path ran through the kernels)
launches = 0
backward_launches = 0


def reset_launches() -> None:
    global launches, backward_launches
    launches = backward_launches = 0


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
            # divisors on the device: PyTorch's CUDA division by a host
            # scalar multiplies by its reciprocal, which rounds otherwise than
            # the division the kernels, the CPU and the JAX oracle make
            wv, hv = (loc_q.new_tensor(float(s)) for s in (Wv, Hv))
            per_level.append(torch.stack([(x + 0.5) / wv, (y + 0.5) / hv], dim=-1))
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
    if value.device.type == "cuda" and loc.data_ptr() % 8:
        raise ValueError("sampling_locations must start on an 8-byte boundary (the kernels read "
                         "(x, y) pairs)")
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


class BackwardPlan(NamedTuple):
    """How one backward call is launched."""

    queries: int  # the sample-gradient kernel's run of queries a block
    vector: bool  # 16 bytes of a head a thread (else one channel)
    group: int  # lanes a (query, head) or a cell: a power of two <= 32
    rows: Tuple[int, ...]  # the value-gradient kernel's band of rows, a level
    smem: Tuple[int, ...]  # its shared memory a block, a level
    sort_smem: int  # the sort kernel's shared memory a block


def backward_plan(value, loc, spatial_shapes: Sequence[Tuple[int, int]]) -> BackwardPlan:
    """The backward kernels' launch for inputs that passed :func:`_check`.
    Plain Python on shapes and the value pointer, so it also runs on CPU
    tensors. Each level's rows are cut into as few even bands as fit a
    block's shared memory; raises ``ValueError`` where the kernels cannot
    take the inputs."""
    M, D = value.shape[2:]
    if D > MAX_BACKWARD_D:
        raise ValueError(f"the backward kernel takes D <= {MAX_BACKWARD_D}, got {D}")
    fwd = kernel_plan(value, loc)
    cpg = D // (16 // value.element_size()) if fwd.vector else D  # chunks a (query, head)
    group = min(32, cpg & -cpg)  # the largest power of two dividing it
    sort_smem = max((h + 1) * (w + 1) + 1 for h, w in spatial_shapes) * 4
    if sort_smem > VALUE_SMEM:
        raise ValueError(f"levels {spatial_shapes} have too many cells for the backward "
                         f"kernels' shared memory")
    rows, smem = [], []
    for H, W in spatial_shapes:
        fit = VALUE_SMEM // (W * D * 4)
        if fit < 1:
            raise ValueError(f"a row of {W} pixels x {D} channels does not fit the backward "
                             f"kernels' shared memory")
        bands = -(-H // fit)
        rows.append(-(-H // bands))
        smem.append(rows[-1] * W * D * 4)
    return BackwardPlan(fwd.queries, fwd.vector, group, tuple(rows), tuple(smem), sort_smem)


def _int_array(xs):
    """A host int32 array for the C entry points."""
    return (ctypes.c_int * len(xs))(*xs)


def _launch(value, spatial_shapes, loc, attn, radius, plan: KernelPlan) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors as ``plan`` says."""
    from dvis_plus_tpu_torch.ops import _build

    global launches
    lib = _build.library()
    B, Len, M, D = value.shape
    Lq, L, P = loc.shape[1], len(spatial_shapes), loc.shape[4]
    out = torch.empty(B, Lq, M * D, dtype=value.dtype, device=value.device)
    shapes = _int_array([s for hw in spatial_shapes for s in hw])
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


def _launch_backward(value, spatial_shapes, loc, attn, radius, grad_out, plan=None):
    """Launch the backward kernels on checked CUDA tensors as ``plan`` (by
    default :func:`backward_plan`) says: (grad_value in ``value.dtype``,
    grad_locations fp32, grad_weights in ``attn.dtype``)."""
    from dvis_plus_tpu_torch.ops import _build

    global backward_launches
    lib = _build.library()
    plan = plan or backward_plan(value, loc, spatial_shapes)
    B, Len, M, D = value.shape
    Lq, L, P = loc.shape[1], len(spatial_shapes), loc.shape[4]
    grad_out = grad_out.to(value.dtype).contiguous()
    if grad_out.data_ptr() % 16:  # the 16-byte instantiation reads it as the value
        grad_out = grad_out.clone()
    # every element written once, from fp32 sums rounded once to the value's type
    grad_value = torch.empty(value.shape, dtype=value.dtype, device=value.device)
    grad_loc = torch.empty_like(loc)
    grad_attn = torch.empty_like(attn)
    # the value gradient's scratch: each (b, m, level)'s samples sorted by
    # corner cell (weight, fractions and query), and where each cell's run
    # starts
    dev = value.device
    rec = torch.empty(L * B * M * Lq * P, 4, dtype=torch.float32, device=dev)
    cell_start = torch.empty(B * M * sum((h + 1) * (w + 1) + 1 for h, w in spatial_shapes),
                             dtype=torch.int32, device=dev)
    shapes = _int_array([s for hw in spatial_shapes for s in hw])
    rows = _int_array(plan.rows)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msdeform_bwd(
            value.data_ptr(), int(value.dtype == torch.bfloat16), loc.data_ptr(), attn.data_ptr(),
            int(attn.dtype == torch.bfloat16), grad_out.data_ptr(), grad_value.data_ptr(),
            grad_loc.data_ptr(), grad_attn.data_ptr(), B, Len, Lq, M, D, L, P,
            ctypes.cast(shapes, ctypes.c_void_p), -1 if radius is None else int(radius),
            plan.queries, int(plan.vector), plan.group, ctypes.cast(rows, ctypes.c_void_p),
            cell_start.data_ptr(), rec.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"msdeform_bwd launch failed: {lib.msdeform_error_string(rc).decode()}"
        )
    backward_launches += 1
    return grad_value, grad_loc, grad_attn


class _MSDeformAttn(torch.autograd.Function):
    """The forward and backward kernels as one differentiable op."""

    @staticmethod
    def forward(ctx, value, loc, attn, spatial_shapes, radius, plan):
        ctx.save_for_backward(value, loc, attn)
        ctx.spatial_shapes, ctx.radius = spatial_shapes, radius
        return _launch(value, spatial_shapes, loc, attn, radius, plan)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        gv, gl, ga = _launch_backward(value, ctx.spatial_shapes, loc, attn, ctx.radius, grad_out)
        return (gv if ctx.needs_input_grad[0] else None, gl if ctx.needs_input_grad[1] else None,
                ga if ctx.needs_input_grad[2] else None, None, None, None)


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    radius: Optional[int] = None,
) -> torch.Tensor:
    """Deformable attention: the CUDA kernels on CUDA tensors (forward, and
    backward under autograd), the twin on CPU tensors. Returns (B, Lq, M*D)
    in ``value.dtype``."""
    spatial_shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    _check(value, spatial_shapes, sampling_locations, attention_weights, radius)
    if value.device.type == "cpu":
        return ms_deform_attn_torch(
            value, spatial_shapes, sampling_locations, attention_weights, radius
        )
    if value.device.type != "cuda":
        raise ValueError(f"no deformable-attention kernel for device {value.device}")
    plan = kernel_plan(value, sampling_locations)
    inputs = (value, sampling_locations, attention_weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        backward_plan(value, sampling_locations, spatial_shapes)  # raises where it cannot run
        return _MSDeformAttn.apply(value, sampling_locations, attention_weights, spatial_shapes,
                                   radius, plan)
    return _launch(value, spatial_shapes, sampling_locations, attention_weights, radius, plan)
