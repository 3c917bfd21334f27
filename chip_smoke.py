#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``dvis_plus_tpu_torch/csrc``, holds
each kernel against its plain PyTorch twin at the shapes the main paths give
it, then drives the main paths with seeded random weights through
``engine.inference.run_vis_inference`` and checks that they went through the
kernels:

- DVIS++ online VIS at the full width of
  ``configs/dvis/dvis_online_r50_ytvis19.yaml`` (kernel B1);
- DVIS++ offline VIS at the full width of
  ``configs/dvis/dvis_offline_swinl_ytvis19.yaml`` (kernels B1 and B2);
- DVIS++ offline VIS at the full width of
  ``configs/dvis/dvis_offline_vitl_ytvis19.yaml`` with
  ``backbone.vit_flash_attention`` on (kernels B1 and B3), at 720x1280
  frames padded to 736x1280;
- MinVIS, CTVIS and Video Mask2Former VIS at the full width of
  ``configs/dvis/{minvis,ctvis,video_maskformer}_r50_ytvis19.yaml`` (kernel
  B1), MinVIS and Video Mask2Former timed at the JAX package's default eval
  settings (``runs`` mask download, threaded eval pipeline), and the two
  downloads against each other on the R50 online and MinVIS paths;
- DVIS++ online video panoptic (VPS) and video semantic (VSS) segmentation
  at the full width of ``configs/dvis/dvis_online_r50_{vipseg,vspw}.yaml``
  (124 classes, kernel B1) through ``run_vps_inference`` /
  ``run_vss_inference`` and the real evaluators, at 720x1280;
- DVIS-DAQ online and offline VIS at the full width of
  ``configs/daq/daq_online_r50_ytvis19.yaml`` and
  ``daq_offline_r50_ovis.yaml`` (kernel B1; the Video Instance Cutter with a
  table of 50 slots, the refiner over the 20 best sequences), its VPS
  route and its VOS writer, GPU against CPU first;
- OV-DVIS++ online and offline open-vocabulary VIS at the full width of
  ``configs/ov/ov_{online,offline}_convnextl_zeroshot_ytvis19.yaml`` (the
  CLIP ConvNeXt-L trunk, the FC-CLIP decoder, kernel B1; the YouTube-VIS 2019
  classifier from the seeded 16-layer text tower, fused with the CLIP head
  against the COCO seen vocabulary) through ``run_ov_inference``, MinVIS OV
  beside them in the GPU-against-CPU phase.

Run from a checkout of the repository:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # build, then only the kernels against their
                                     # plain versions and the wrappers' host time
    python3 chip_smoke.py --profile [vitl] [swinl] [r50] [daq] [ov]
                                     # build, then stage times and a torch.profiler
                                     # breakdown of one video of each slice named
    python3 chip_smoke.py --b1-runs  # build, then kernel B1's time at its main shapes
                                     # by the run of queries a block takes
    python3 chip_smoke.py --daq      # build, then only the DVIS-DAQ phases
    python3 chip_smoke.py --ov       # build, then only the open-vocabulary phases

Kernel B1 (deformable attention) is held and timed at each of its three
main shapes under two distributions of sampling offsets: uniform over +-10
value pixels (+-6 at the extractor), which leaves neighbouring queries few
corners in common, and the offsets the model's own initialisation gives
(head m points in direction m, point p at p pixels, plus noise of a quarter
pixel), where they share most. Beside its bound the line gives the bytes it
gathers (samples x 4 corners x D x itemsize) and the rate they imply.

The ``build`` phase also builds the port's native RLE codec
(``dvis_plus_tpu_torch/native/rle.cpp``, g++), which encodes every
``results.json`` row. Each phase prints one JSON line. The ``kernels`` line
gives, for every kernel, its launches on its main path and by path, its
time, its plain version's time, the time of the one PyTorch call that
computes the same function (``library_ms``, timed here and called nowhere
in the port) and its bound:
the larger of bytes moved (each input read once, each output written once)
over 3.35 TB/s and operations over the peak for the input type (989 TFLOP/s
bf16, 67 TFLOP/s fp32), NVIDIA's published H100 SXM rates. The last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed; any
failure raises (exit code != 0). It needs CUDA and exits non-zero without it.

Numerics: TF32 is off for matmuls and convolutions in every phase, so the
fp32 parts (the deformable encoder island, mask products) run in full fp32;
the timed slices run the configuration's ``compute_dtype`` (bfloat16). The
seeded random ViT-L gets LayerScale gains of 0.1 (a trained checkpoint's
order) instead of the 1e-5 initial value, so that trunk attention carries
weight in what the phases compare. The seeded random DVIS-DAQ models get
their class heads' no-object logits shifted and the cutter's class head
scaled (``DAQ_HEADS``, ``DAQ_PARITY_HEADS`` say how and why), so that the
first frame starts no sequence, the second fills the table, and the
selection thresholds separate queries. The seeded random OV models get
ConvNeXt layer scales of 0.1 and every ``logit_scale`` at 4 (``ov_model``).
The whole script's wall time is printed before the card's name.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; fp32 CUDA cores

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
LEVELS = [(60, 80), (30, 40), (15, 20)]  # 480x640 input: strides 8, 16, 32
VIT_LEVELS = [(92, 160), (46, 80), (23, 40)]  # 736x1280 input: the ViT-L slice's encoder
FRAMES, VIDEOS, H_IN, W_IN, H_OUT, W_OUT = 15, 2, 480, 640, 720, 960
KERNEL_REPS = 10  # back-to-back launches per timed run of a kernel or a library call
KERNEL_TOL = 1e-5  # max |kernel - twin| / max |twin|, both accumulate in fp32
# B2 in bf16: p and the output round to bf16 on both sides after sums taken
# in different orders, so they may differ by one bf16 ulp of the output
KERNEL_TOL_BF16 = 1e-2
SLICE_TOL = 1e-3  # GPU (kernel, cuDNN) vs CPU (twin) fp32 path, small input
# ViT-L serving size: 720x1280 frames padded to 736x1280, a 46x80 token grid
VIT_FRAMES, VIT_H, VIT_W, VIT_H_OUT, VIT_W_OUT = 10, 736, 1280, 720, 1280
VIT_GRID = (46, 80)
# (B, L, H), Dh = 64: the serving size, the parity phase's size, and one
# 480x640 frame's 30x40 + 1 tokens (ten 128-key tiles: a short ragged length)
FLASH_SHAPES = [(5, 3681, 16), (2, 2049, 16), (5, 1201, 16)]
# bf16 ViT-L backbone features: kernel B3 against dense attention, and each of
# the two against an fp32 evaluation of the same weights, as relative RMS. The
# largest single difference is a few bf16 ulps of the feature maximum between
# any two of the three (the phase prints all of them), so it is held to
# DENSE_MAX_TOL
DENSE_TOL = 2e-2
DENSE_MAX_TOL = 5e-2
# B2 shapes of Swin-L (window 12, N = 144, Dh = 32) at 480x640 and 5 frames.
# The token map of each stage is padded to a multiple of the window: stage 0
# 120x160 -> 120x168 = 140 windows, stage 1 60x80 -> 60x84 = 35, stage 2
# 30x40 -> 36x48 = 12, stage 3 15x20 -> 24x24 = 4. "blocks" is the stage's
# depth: B2 launches that many times per window of frames (2 / 2 / 18 / 2)
SWIN_STAGES = [
    {"stage": 0, "B_": 5 * 140, "heads": 6, "map": (120, 168), "nW": 140, "blocks": 2},
    {"stage": 1, "B_": 5 * 35, "heads": 12, "map": (60, 84), "nW": 35, "blocks": 2},
    {"stage": 2, "B_": 5 * 12, "heads": 24, "map": (36, 48), "nW": 12, "blocks": 18},
    {"stage": 3, "B_": 5 * 4, "heads": 48, "map": (24, 24), "nW": 4, "blocks": 2},
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, reps: int = 1) -> float:
    """Median milliseconds of one call of ``fn`` over ``iters`` CUDA-event-timed
    runs of ``reps`` calls back to back. With one call between the events the
    card waits for the host to prepare the launch, and that wait is timed
    too (tens of microseconds for a wrapper call): ``reps`` of 10 keeps the
    queue fed, so the time is the kernel's unless the host is the slower."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def bound(tensors, flops, dtype):
    """(bound_ms, bound_by): the least time the card could take. ``tensors``
    are the inputs and outputs (each moved once), ``flops`` the operations
    on them, held to the peak for ``dtype``."""
    t_bytes = sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, power = [s.strip() for s in smi.split(",", 1)]
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "name": name, "power.limit": power})
    return smi


def phase_build():
    from dvis_plus_tpu_torch.ops import _build
    from dvis_plus_tpu_torch.utils import rle

    t0 = time.perf_counter()
    path = _build.build()
    seconds = time.perf_counter() - t0
    _build.library()  # loads and binds every entry point
    t0 = time.perf_counter()
    codec = rle.build()
    codec_seconds = time.perf_counter() - t0
    rle.library()
    emit({"phase": "build", "seconds": seconds, "library": os.path.relpath(path, REPO),
          "codec_seconds": codec_seconds, "codec": os.path.relpath(codec, REPO),
          "ptxas": _build.resource_usage()})


def init_offsets(M, L, P):
    """(M, L, P, 2) sampling offsets in pixels as ``MSDeformAttn``'s
    initialisation sets them: head m points in direction m (scaled to the
    unit square's border), point p lies p pixels out."""
    import torch

    thetas = torch.arange(M, dtype=torch.float32) * (2.0 * math.pi / M)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    steps = torch.arange(1, P + 1, dtype=torch.float32)
    return (grid[:, None, None, :] * steps[None, None, :, None]).expand(M, L, P, 2)


def sampling_offsets(g, BT, Lq, M, L, P, offsets, spread):
    """(BT, Lq, M, L, P, 2) offsets in value pixels: ``uniform`` over
    +-``spread``, or ``init``: the initialisation's plus N(0, 0.25) noise."""
    import torch

    if offsets == "uniform":
        return (torch.rand(BT, Lq, M, L, P, 2, generator=g) * 2 - 1) * spread
    return init_offsets(M, L, P) + 0.25 * torch.randn(BT, Lq, M, L, P, 2, generator=g)


def msdeform_inputs(dev, levels=LEVELS, seed=SEED, BT=5, M=8, D=32, P=4, offsets="uniform"):
    """Encoder-shaped inputs: queries are the level grids. ``uniform``
    offsets reach 10 pixels, so some locations leave [0, 1] and some exceed
    the radius."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    Len = sum(h * w for h, w in levels)
    L = len(levels)
    refs = []
    for H, W in levels:
        ry = (torch.arange(H) + 0.5) / H
        rx = (torch.arange(W) + 0.5) / W
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = torch.cat(refs)[None, :, None, None, None, :]
    norm = torch.tensor([[w, h] for h, w in levels], dtype=torch.float32)[None, None, None, :, None]
    off = sampling_offsets(g, BT, Len, M, L, P, offsets, 10.0)
    loc = (ref + off / norm).contiguous()
    attn = torch.rand(BT, Len, M, L * P, generator=g).softmax(-1).reshape(BT, Len, M, L, P)
    value = torch.randn(BT, Len, M, D, generator=g)
    return value.to(dev), loc.to(dev), attn.contiguous().to(dev)


def kernel_check(name, got_fn, want_fn, tol, iters=20, plain_iters=10):
    """Kernel output against its twin's, then both timed. Raises on a
    disagreement beyond ``tol`` (relative to the twin's max)."""
    import torch

    got = got_fn()
    torch.cuda.synchronize()
    want = want_fn()
    err = (got.float() - want.float()).abs().max().item()
    res = {"max_abs_err": err, "rel_err": err / want.float().abs().max().item(), "tol": tol}
    if not (np.isfinite(res["rel_err"]) and res["rel_err"] <= tol):
        emit({"phase": "kernels", "kernel": name, "failed": res})
        raise AssertionError(f"{name} disagrees with its twin: {res}")
    res["ms"] = cuda_ms(got_fn, iters, KERNEL_REPS)
    res["plain_ms"] = cuda_ms(want_fn, plain_iters)
    return res


def b1_check(levels, value, loc, attn, radius=None, **timing):
    """B1 against its twin on these inputs, timed, with its bound and the
    bytes it gathers. The bar follows the output's type: fp32 sums on both
    sides (1e-5 of the twin's maximum), rounded once to bf16 where the value
    is bf16 (one bf16 ulp of the output: 1e-2)."""
    import torch

    from dvis_plus_tpu_torch.ops import msdeform

    out_dtype = msdeform.ms_deform_attn(value[:1], levels, loc[:1], attn[:1], radius=radius).dtype
    res = kernel_check(
        "msdeform_fwd",
        lambda: msdeform.ms_deform_attn(value, levels, loc, attn, radius=radius),
        lambda: msdeform.ms_deform_attn_torch(value, levels, loc, attn, radius=radius),
        KERNEL_TOL_BF16 if out_dtype == torch.bfloat16 else KERNEL_TOL, **timing,
    )
    res["bound_ms"], res["bound_by"] = msdeform_bound(value, loc, attn, out_dtype)
    # every sample reads four corners of D values, whatever the mapping
    res["gathered_bytes"] = attn.numel() * 4 * value.shape[-1] * value.element_size()
    res["gathered_tb_per_s"] = res["gathered_bytes"] / (res["ms"] * 1e-3) / 1e12
    return {"radius": radius, "value_dtype": str(value.dtype).split(".")[1],
            "attn_dtype": str(attn.dtype).split(".")[1], "out_dtype": str(out_dtype).split(".")[1],
            **res}


# B1 at small odd shapes, checked and not timed: (levels, B, M, D, P). Level
# grids of odd sizes (runs of queries that span two levels), a level one pixel wide, a head of
# 16 bytes, M * D = 1024, rows of 24 bytes (the scalar instantiation)
B1_ODD_SHAPES = [
    ([(7, 9), (3, 5), (2, 2)], 3, 8, 32, 4),
    ([(5, 1), (1, 7), (1, 1)], 2, 4, 8, 4),
    ([(6, 5), (3, 3)], 1, 2, 4, 2),
    ([(9, 11), (5, 6), (3, 3)], 2, 16, 64, 4),
    ([(7, 6), (4, 3)], 2, 3, 6, 3),
]


def b1_odd_shapes(dev):
    """B1 against its twin round the edges of its tiling and of its two
    instantiations, both forms, fp32 and bf16, and on a contiguous value that
    starts off a 16-byte boundary."""
    import torch

    from dvis_plus_tpu_torch.ops import msdeform

    worst = {"float32": 0.0, "bfloat16": 0.0}
    n = 0
    for levels, B, M, D, P in B1_ODD_SHAPES:
        value, loc, attn = msdeform_inputs(dev, levels, SEED + 5, B, M, D, P)
        loc[0, 0, 0, 0, 0] = torch.tensor([0.0, 1.0])  # exactly on the border
        loc[0, 1, 0, 0, 0] = torch.tensor([1.0 + 0.5 / levels[0][1], 0.5])  # half a pixel outside
        loc[0, 2, 0, 0, 0] = torch.tensor([37.0, -1e6])  # far outside
        for dtype in (torch.float32, torch.bfloat16):
            flat = torch.zeros(value.numel() + 1, device=dev, dtype=dtype)
            shifted = flat[1:].view_as(value).copy_(value)  # one element past the allocation's start
            for v in (value.to(dtype), shifted):
                for radius in (None, 2):
                    got = msdeform.ms_deform_attn(v, levels, loc, attn, radius=radius)
                    torch.cuda.synchronize()
                    want = msdeform.ms_deform_attn_torch(v, levels, loc, attn, radius=radius)
                    rel = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
                    name = str(got.dtype).split(".")[1]
                    tol = KERNEL_TOL_BF16 if got.dtype == torch.bfloat16 else KERNEL_TOL
                    if not (np.isfinite(rel) and rel <= tol):
                        raise AssertionError(f"msdeform_fwd disagrees with its twin at {levels}, "
                                             f"B {B} M {M} D {D} P {P} {dtype} radius {radius}: {rel}")
                    worst[name] = max(worst[name], rel)
                    n += 1
    emit({"phase": "kernels", "kernel": "msdeform_fwd", "odd_shapes": len(B1_ODD_SHAPES),
          "checks": n, "worst_rel_err_by_out_dtype": worst,
          "tol": {"float32": KERNEL_TOL, "bfloat16": KERNEL_TOL_BF16}})


def window_attention_fp64(q, k, v, bias, mask, H):
    """Window attention in float64: the value that B2 and its twin round."""
    B_, N, C = q.shape

    def heads(x):
        return x.double().reshape(B_, N, H, C // H).transpose(1, 2)

    a = heads(q) @ heads(k).transpose(-1, -2) * (C // H) ** -0.5 + bias.double()
    if mask is not None:
        nW = mask.shape[0]
        a = (a.reshape(B_ // nW, nW, H, N, N) + mask.double()[None, :, None]).reshape(B_, H, N, N)
    return (a.softmax(-1) @ heads(v)).transpose(1, 2).reshape(B_, N, C)


def msdeform_bound(value, loc, attn, out_dtype):
    """B1: value, locations and weights read once, the output written once
    in ``out_dtype``; per sample and channel four bilinear FMAs and one
    weight FMA."""
    import torch

    B, Lq, M, L, P = attn.shape
    out = torch.empty(B, Lq, M * value.shape[-1], device="meta", dtype=out_dtype)
    return bound((value, loc, attn, out), 10 * attn.numel() * value.shape[-1], value.dtype)


def extractor_grids():
    Hv, Wv = VIT_GRID
    return [(2 * Hv, 2 * Wv), (Hv, Wv), (Hv // 2, Wv // 2)]


def extractor_inputs(dev, seed=SEED, BT=5, M=16, D=64, P=4, offsets="uniform"):
    """B1 as the ViT-L adapter's extractors call it: the three spatial grids
    (92x160, 46x80, 23x40 = 19,320 queries a frame) attend into the one
    46x80 ViT level, 16 heads of 64 channels. ``uniform`` offsets reach 6
    pixels."""
    import torch

    from dvis_plus_tpu_torch.models.segmenter.pixel_decoder import reference_points

    g = torch.Generator(device="cpu").manual_seed(seed)
    Hv, Wv = VIT_GRID
    ref = reference_points(extractor_grids())[:, 1:2][None, :, None, :, None, :]  # (1, Lq, 1, 1, 1, 2)
    Lq = ref.shape[1]
    off = sampling_offsets(g, BT, Lq, M, 1, P, offsets, 6.0)
    loc = (ref + off / torch.tensor([Wv, Hv], dtype=torch.float32)).contiguous()
    attn = torch.rand(BT, Lq, M, P, generator=g).softmax(-1).reshape(BT, Lq, M, 1, P)
    value = torch.randn(BT, Hv * Wv, M, D, generator=g)
    return value.to(dev), loc.to(dev), attn.contiguous().to(dev)


def attention_fp64(q, k, v):
    """Self-attention in float64, one batch element at a time: the value
    that B3, its plain version and the library call round."""
    import torch

    outs = []
    for b in range(q.shape[0]):
        qb, kb, vb = (t[b].double().transpose(0, 1) for t in (q, k, v))  # (H, L, Dh)
        p = (qb @ kb.transpose(-1, -2) * q.shape[-1] ** -0.5).softmax(-1)
        outs.append((p @ vb).transpose(0, 1))
    return torch.stack(outs)


def phase_kernels(dev):
    """B1 against its twin at small odd shapes, then at the R50 and Swin-L
    slices' encoder shape, both forms, and at the ViT-L slice's two shapes
    (its pixel decoder's encoder at 736x1280 and its extractors), each under
    uniform offsets and under the initialisation's; B2 at the Swin-L stages' shapes, with and
    without the shift mask; B3 at the ViT-L trunk's shapes and at one short
    ragged length, contiguous and as views of a fused qkv tensor; fp32 and
    bf16. Beside B2 and B3,
    ``scaled_dot_product_attention`` on the same tensors, as a yardstick."""
    import torch
    import torch.nn.functional as F

    from dvis_plus_tpu_torch.models.backbones.swin import shift_mask
    from dvis_plus_tpu_torch.ops import flash_attn, msdeform, swin_window_attn

    b1_odd_shapes(dev)
    b1, b1v, b1x = [], [], []
    for offsets in ("uniform", "init"):
        value, loc, attn = msdeform_inputs(dev, offsets=offsets)
        for radius in (None, 7):
            for dtype in (torch.float32, torch.bfloat16):
                b1.append({"offsets": offsets, **b1_check(LEVELS, value.to(dtype), loc, attn, radius)})
    emit({"phase": "kernels", "kernel": "msdeform_fwd",
          "shapes": {"value": list(value.shape), "loc": list(loc.shape)}, "forms": b1})

    # the ViT-L slice's encoder: half of B1's launches on that path
    for offsets in ("uniform", "init"):
        value, loc, attn = msdeform_inputs(dev, VIT_LEVELS, offsets=offsets)
        b1v.append({"offsets": offsets,
                    **b1_check(VIT_LEVELS, value, loc, attn, iters=20, plain_iters=3)})
    emit({"phase": "kernels", "kernel": "msdeform_fwd", "caller": "ViT-L slice's pixel decoder",
          "shapes": {"value": list(value.shape), "loc": list(loc.shape)}, "forms": b1v})

    # the extractors: the weights come in the value's dtype, as the adapter
    # hands them over
    for offsets in ("uniform", "init"):
        value, loc, attn = extractor_inputs(dev, offsets=offsets)
        for dtype in (torch.bfloat16, torch.float32):
            b1x.append({"offsets": offsets, **b1_check(
                [VIT_GRID], value.to(dtype), loc, attn.to(dtype), iters=10, plain_iters=3)})
    emit({"phase": "kernels", "kernel": "msdeform_fwd", "caller": "vit_adapter extractor",
          "shapes": {"value": list(value.shape), "loc": list(loc.shape)}, "forms": b1x})
    del value, loc, attn

    g = torch.Generator(device="cpu").manual_seed(SEED)
    b2 = []
    for st in SWIN_STAGES:
        B_, H = st["B_"], st["heads"]
        C = 32 * H
        qkv = torch.randn(B_, 144, 3 * C, generator=g).to(dev)  # one qkv output
        bias = (torch.randn(H, 144, 144, generator=g) * 2.0).to(dev)
        for masked in (True, False):
            mask = shift_mask(*st["map"], 12, 6, dev) if masked else None
            for dtype, tol in ((torch.float32, KERNEL_TOL), (torch.bfloat16, KERNEL_TOL_BF16)):
                q, k, v = qkv.to(dtype).split(C, dim=-1)
                forms = {
                    "kernel": lambda: swin_window_attn.window_attention(q, k, v, bias, mask, H),
                    "twin": lambda: swin_window_attn.window_attention_torch(q, k, v, bias, mask, H),
                }
                res = kernel_check("swin_window_attn_fwd", forms["kernel"], forms["twin"], tol)
                out = torch.empty(B_, 144, C, device="meta", dtype=dtype)
                res["bound_ms"], res["bound_by"] = bound(
                    (q, k, v, out, bias) + (() if mask is None else (mask,)),
                    4 * B_ * H * 144 * 144 * 32, dtype)
                # the library call takes bias and mask as one additive
                # tensor, combined here outside the timed call
                add = bias[None]  # (1, H, N, N), broadcast over the windows
                if mask is not None:  # window i takes mask row i % nW
                    add = (bias[None, None] + mask[None, :, None]).expand(
                        B_ // st["nW"], -1, -1, -1, -1).reshape(B_, H, 144, 144)
                add = add.to(dtype).contiguous()
                qh, kh, vh = (t.unflatten(-1, (H, 32)).transpose(1, 2) for t in (q, k, v))
                res["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=add), 20, KERNEL_REPS)
                del add
                if dtype == torch.float32:
                    # kernel and twin may agree bit for bit (the same fp32
                    # sums in the same order); each one's distance from the
                    # exact value shows what the fp32 path rounds away
                    exact = window_attention_fp64(q, k, v, bias, mask, H)
                    scale = exact.abs().max().item()
                    res["fp64_rel_err"] = {
                        name: (fn().double() - exact).abs().max().item() / scale
                        for name, fn in forms.items()
                    }
                b2.append({"stage": st["stage"], "blocks": st["blocks"], "B_": B_, "C": C, "heads": H,
                           "nW": st["nW"] if masked else 0, "dtype": str(dtype).split(".")[1],
                           **res})
    emit({"phase": "kernels", "kernel": "swin_window_attn_fwd", "N": 144, "forms": b2})
    del qkv, bias, q, k, v

    b3 = []
    for B, L, H in FLASH_SHAPES:
        C = 64 * H
        qkv = torch.randn(B, L, 3 * C, generator=g).to(dev)
        for dtype, tol in ((torch.float32, KERNEL_TOL), (torch.bfloat16, KERNEL_TOL_BF16)):
            fused = [t.unflatten(-1, (H, 64)) for t in qkv.to(dtype).split(C, dim=-1)]
            for layout in ("fused_qkv_views", "contiguous"):
                q, k, v = fused if layout == "fused_qkv_views" else [t.contiguous() for t in fused]
                qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, L, Dh) views
                forms = {
                    "kernel": lambda: flash_attn.flash_self_attention(q, k, v),
                    "twin": lambda: flash_attn.attention_torch(q, k, v),
                    "library": lambda: F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2),
                }
                res = kernel_check("flash_attn_fwd", forms["kernel"], forms["twin"], tol,
                                   iters=10, plain_iters=3)
                res["library_ms"] = cuda_ms(forms["library"], 20, KERNEL_REPS)
                res["bound_ms"], res["bound_by"] = bound(
                    (q, k, v, torch.empty(B, L, C, device="meta", dtype=dtype)),
                    4 * B * H * L * L * 64, dtype)
                if layout == "fused_qkv_views":
                    exact = attention_fp64(q, k, v)
                    scale = exact.abs().max().item()
                    res["fp64_rel_err"] = {
                        name: (fn().double() - exact).abs().max().item() / scale
                        for name, fn in forms.items()
                    }
                    del exact
                b3.append({"B": B, "L": L, "heads": H, "dtype": str(dtype).split(".")[1],
                           "layout": layout, **res})
    emit({"phase": "kernels", "kernel": "flash_attn_fwd", "Dh": 64, "forms": b3})
    return {"encoder": b1, "vitl_encoder": b1v, "vitl_extractor": b1x}, b2, b3


def phase_b1_runs(dev):
    """B1's time at its three main shapes (exact form; the encoders in fp32,
    the extractor in bf16) under both offset distributions, by the run of
    consecutive queries a block takes: what ``ops/msdeform.py``'s ``MAX_RUN``
    rests on. Every run length gives the same bits."""
    import torch

    from dvis_plus_tpu_torch.ops import msdeform

    shapes = {
        "encoder_480x640": (LEVELS, lambda o: msdeform_inputs(dev, offsets=o), torch.float32),
        "vitl_encoder_736x1280": (VIT_LEVELS, lambda o: msdeform_inputs(dev, VIT_LEVELS, offsets=o),
                                  torch.float32),
        "vitl_extractor": ([VIT_GRID], lambda o: extractor_inputs(dev, offsets=o), torch.bfloat16),
    }
    for name, (levels, make, dtype) in shapes.items():
        for offsets in ("uniform", "init"):
            value, loc, attn = (t.to(dtype) if i != 1 else t for i, t in enumerate(make(offsets)))
            want = msdeform.ms_deform_attn(value, levels, loc, attn)
            plan = msdeform.kernel_plan(value, loc)
            rows = []
            for queries in (1, 2, 4, 8, 16):
                def fn():
                    return msdeform._launch(value, levels, loc, attn, None, plan._replace(queries=queries))

                if not torch.equal(fn(), want):
                    raise AssertionError(f"B1 changed its bits with runs of {queries} at {name}")
                rows.append({"queries": queries, "ms": cuda_ms(fn, 10, KERNEL_REPS)})
            emit({"phase": "b1_runs", "shape": name, "offsets": offsets,
                  "value_dtype": str(dtype).split(".")[1], "plan": list(plan), "rows": rows})


def phase_host_call(dev, calls=1000):
    """Host time of one wrapper call of B2 and B3 in bf16: the wall time of
    ``calls`` calls without a synchronization, divided, at shapes so small
    that the card stays ahead of the host (the paths are bound by eager
    dispatch, so what a call costs the host matters beside its kernel)."""
    import torch

    from dvis_plus_tpu_torch.ops import flash_attn, swin_window_attn

    g = torch.Generator(device="cpu").manual_seed(SEED)
    qkv = torch.randn(1, 128, 3 * 1024, generator=g).to(dev, torch.bfloat16)
    q3, k3, v3 = (t.unflatten(-1, (16, 64)) for t in qkv.split(1024, dim=-1))
    wqkv = torch.randn(4, 144, 3 * 192, generator=g).to(dev, torch.bfloat16)
    q2, k2, v2 = wqkv.split(192, dim=-1)
    bias = torch.randn(6, 144, 144, generator=g).to(dev)
    fns = {"flash_attn_fwd": lambda: flash_attn.flash_self_attention(q3, k3, v3),
           "swin_window_attn_fwd": lambda: swin_window_attn.window_attention(q2, k2, v2, bias, None, 6)}
    res = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        res[name] = 1e6 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
    emit({"phase": "host_call", "calls": calls, "dtype": "bfloat16", "host_us_per_call": res})


def synthetic_videos(n, T, H, W, Ho, Wo, seed, valid=None):
    """``valid``: the (h, w) of the frame on the padded (H, W) canvas."""
    rng = np.random.RandomState(seed)
    for vid in range(n):
        yield {
            "images": rng.randn(T, H, W, 3).astype(np.float32),
            "image_size": np.asarray(valid or [H, W], np.int32),
            "height": Ho, "width": Wo, "video_id": vid + 1,
        }


def build_model(cfg, dev):
    import torch

    from dvis_plus_tpu_torch.cli import build_model as build_arch

    torch.manual_seed(SEED)
    model = build_arch(cfg.model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith((".ls1.gamma", ".ls2.gamma")):  # ViT LayerScale
                p.fill_(0.1)
    return model.to(dev).eval()


def phase_slice_parity(dev):
    """The whole path at fp32 on a small input: GPU (kernel, cuDNN) against
    the CPU (twin), same seeded weights."""
    import torch

    from dvis_plus_tpu_torch.config import dvis_online_r50_ytvis19
    from dvis_plus_tpu_torch.engine.inference import _online_video

    cfg = dvis_online_r50_ytvis19()
    cfg.model.compute_dtype = "float32"
    images = next(synthetic_videos(1, 5, 128, 160, 128, 160, SEED + 1))["images"]
    out = {}
    with torch.inference_mode():
        for d in (dev, torch.device("cpu")):
            logits, masks, _ = _online_video(cfg, build_model(cfg, d), images, cfg.test.window_size)
            out[d.type] = (logits.float().cpu(), masks.float().cpu())
    errs = {}
    for i, name in enumerate(("logits", "masks")):
        a, b = out["cuda"][i], out["cpu"][i]
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {name} on the GPU")
        errs[name] = ((a - b).abs().max() / b.abs().max()).item()
    emit({"phase": "slice_parity", "input": [5, 128, 160], "rel_err": errs, "tol": SLICE_TOL})
    if max(errs.values()) > SLICE_TOL:
        raise AssertionError(f"GPU path disagrees with the CPU path: {errs}")


def phase_swinl_slice_parity(dev):
    """The whole offline Swin-L path at full width, fp32, on a small input
    (7 frames at 128x160, window 5: two windows, the last ragged): GPU
    (kernels, cuDNN) against the CPU (twins), same seeded weights. The exact
    JV matcher (the parity setting) keeps near-tied assignment costs from
    deciding differently on the two devices."""
    import torch

    from dvis_plus_tpu_torch.config import dvis_offline_swinl_ytvis19
    from dvis_plus_tpu_torch.engine.inference import _online_video

    cfg = dvis_offline_swinl_ytvis19()
    cfg.model.compute_dtype = "float32"
    cfg.model.tracker.matcher_solver = "jv"
    images = next(synthetic_videos(1, 7, 128, 160, 128, 160, SEED + 2))["images"]
    out = {}
    with torch.inference_mode():
        for d in (dev, torch.device("cpu")):
            res = _online_video(cfg, build_model(cfg, d), images, cfg.test.window_size)
            out[d.type] = [x.float().cpu() for x in res]
    errs = {}
    for i, name in enumerate(("logits", "masks", "aux")):
        a, b = out["cuda"][i], out["cpu"][i]
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {name} on the GPU")
        errs[name] = ((a - b).abs().max() / b.abs().max()).item()
    emit({"phase": "swinl_slice_parity", "input": [7, 128, 160], "window": cfg.test.window_size,
          "rel_err": errs, "tol": SLICE_TOL})
    if max(errs.values()) > SLICE_TOL:
        raise AssertionError(f"GPU Swin-L path disagrees with the CPU path: {errs}")


# B2's launches since the last reset by (B_, heads, shift mask given), as the
# hooks of phase_swinl_slice count them
B2_BY_SHAPE = {}


def reset_launches() -> None:
    from dvis_plus_tpu_torch.ops import flash_attn, msdeform, swin_window_attn

    for mod in (msdeform, swin_window_attn, flash_attn):
        mod.reset_launches()
    B2_BY_SHAPE.clear()


def read_launches() -> dict:
    from dvis_plus_tpu_torch.ops import flash_attn, msdeform, swin_window_attn

    return {"msdeform_fwd": msdeform.launches, "swin_window_attn_fwd": swin_window_attn.launches,
            "flash_attn_fwd": flash_attn.launches}


def timed_slice(cfg, dev, frames=FRAMES, canvas=(H_IN, W_IN), valid=None, out=(H_OUT, W_OUT),
                model=None, around=contextlib.nullcontext, run=None):
    """``VIDEOS`` synthetic videos x ``frames`` frames on a ``canvas`` input
    (by default 2 x 15 at 480x640, output 720x960) through ``run`` (by
    default ``run_vis_inference``; ``run(cfg, model, loader, evaluator,
    timings)``) after one untimed warm-up video; every kernel's launch
    count is set to 0 just before the timed run and read just after. The
    timed run is made inside the context ``around()``. Returns
    (measurements, whether the rows are well formed, the results.json
    bytes)."""
    import torch

    from dvis_plus_tpu_torch.engine.inference import run_vis_inference
    from dvis_plus_tpu_torch.evaluation.evaluators import YTVISEvaluator

    run_vis_inference = run or run_vis_inference

    class Counting(YTVISEvaluator):  # frames whose runs download fell back to packed pixels
        frames = fallback = 0

        def process(self, video_id, output):
            masks = output["pred_masks"]
            self.frames += masks.shape[0] * masks.shape[1]
            self.fallback += len(getattr(masks, "fallback", ()))
            super().process(video_id, output)

    model = model or build_model(cfg, dev)
    with tempfile.TemporaryDirectory() as tmp:
        # warm-up video (cuDNN / cuBLAS autotuning, allocator), not timed
        run_vis_inference(cfg, model, synthetic_videos(1, 5, *canvas, *out, 99, valid),
                          YTVISEvaluator("warmup", tmp))
        evaluator = Counting("synthetic", tmp)
        timings = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with around():
            t0 = time.perf_counter()
            run_vis_inference(cfg, model, synthetic_videos(VIDEOS, frames, *canvas, *out, SEED, valid),
                              evaluator, timings)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_launches()
        rows = evaluator.predictions
        with open(evaluator.write_results(), "rb") as f:
            results = f.read()
    topk = cfg.test.max_num
    videos = sorted({r["video_id"] for r in rows})
    rows_ok = (
        len(rows) == VIDEOS * topk
        and videos == list(range(1, VIDEOS + 1))
        and all(0.0 <= r["score"] <= 1.0 for r in rows)
        and all(1 <= r["category_id"] <= cfg.model.num_classes for r in rows)
        and all(len(r["segmentations"]) == frames for r in rows)
        and all(s is None or s["size"] == list(out) for r in rows for s in r["segmentations"])
    )
    res = {"compute_dtype": cfg.model.compute_dtype, "tf32": False, "videos": VIDEOS,
           "frames": frames, "input": list(canvas), "window": cfg.test.window_size,
           "mask_download": cfg.test.mask_download, "rle_col_k": cfg.test.rle_col_k,
           "eval_pipeline": cfg.test.eval_pipeline, "matcher": cfg.model.tracker.matcher_solver,
           "wall_s": wall, "fps": VIDEOS * frames / wall,
           "model_fps": VIDEOS * frames / timings["model_s"], "post_s": timings["post_s"],
           "rows_s": timings["rows_s"], "fallback_frames": evaluator.fallback,
           "masks": evaluator.frames,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "rows": len(rows),
           "results_json_bytes": len(results), "launches": launches}
    return res, rows_ok, results


def phase_slice(dev, impl):
    """Full-width R50 DVIS++ online over 2 videos x 15 frames at 480x640."""
    from dvis_plus_tpu_torch.config import dvis_online_r50_ytvis19

    cfg = dvis_online_r50_ytvis19()
    cfg.model.pixel_decoder.msdeform_impl = impl
    res, rows_ok, _ = timed_slice(cfg, dev)
    windows = VIDEOS * -(-FRAMES // cfg.test.window_size)
    expect = {"msdeform_fwd": cfg.model.pixel_decoder.transformer_enc_layers * windows,
              "swin_window_attn_fwd": 0, "flash_attn_fwd": 0}
    res = {"phase": "slice", "msdeform_impl": impl, **res, "expected_launches": expect}
    emit(res)
    if not (rows_ok and res["launches"] == expect):
        raise AssertionError(f"slice check failed ({impl}): {res}")
    return res


def phase_swinl_slice(dev):
    """Full-width Swin-L DVIS++ offline over 2 videos x 15 frames at 480x640:
    B2 runs once per Swin block and window, B1 once per encoder layer and
    window."""
    from dvis_plus_tpu_torch.config import dvis_offline_swinl_ytvis19
    from dvis_plus_tpu_torch.models.backbones.swin import WindowAttention
    from dvis_plus_tpu_torch.ops import swin_window_attn

    cfg = dvis_offline_swinl_ytvis19()
    model = build_model(cfg, dev)
    # B2's launches by shape: what the count rose by across each attention
    # module's forward, keyed by (B_, heads, shift mask given)
    before = {}

    def pre(mod, args, kwargs):
        before[mod] = swin_window_attn.launches

    def post(mod, args, kwargs, out):
        masked = (args[1] if len(args) > 1 else kwargs.get("mask")) is not None
        key = (args[0].shape[0], mod.num_heads, masked)
        B2_BY_SHAPE[key] = B2_BY_SHAPE.get(key, 0) + swin_window_attn.launches - before[mod]

    for mod in model.modules():
        if isinstance(mod, WindowAttention):
            mod.register_forward_pre_hook(pre, with_kwargs=True)
            mod.register_forward_hook(post, with_kwargs=True)
    res, rows_ok, _ = timed_slice(cfg, dev, model=model)
    res["b2_launches_by_shape"] = [
        {"B_": B_, "heads": H, "masked": masked, "launches": n}
        for (B_, H, masked), n in sorted(B2_BY_SHAPE.items())]
    windows = VIDEOS * -(-FRAMES // cfg.test.window_size)
    expect = {"msdeform_fwd": cfg.model.pixel_decoder.transformer_enc_layers * windows,
              "swin_window_attn_fwd": sum(cfg.model.backbone.swin_depths) * windows,
              "flash_attn_fwd": 0}
    res = {"phase": "swinl_slice", "backbone": cfg.model.backbone.name,
           "meta_architecture": cfg.model.meta_architecture, **res, "expected_launches": expect}
    emit(res)
    counted = sum(f["launches"] for f in res["b2_launches_by_shape"])
    if not (rows_ok and res["launches"] == expect and counted == expect["swin_window_attn_fwd"]):
        raise AssertionError(f"Swin-L slice check failed: {res}")
    return res


def vitl_cfg():
    from dvis_plus_tpu_torch.config import dvis_offline_vitl_ytvis19

    cfg = dvis_offline_vitl_ytvis19()
    cfg.model.backbone.vit_flash_attention = True
    return cfg


def phase_vitl_slice_parity(dev):
    """The whole offline ViT-L path at full width, fp32, on 2 frames of
    512x1024 (32x64 + 1 = 2049 tokens, so B3 runs), window 2: GPU (kernels,
    cuDNN) against the CPU (plain versions), same seeded weights, exact JV
    matcher."""
    import torch

    from dvis_plus_tpu_torch.engine.inference import _online_video

    cfg = vitl_cfg()
    cfg.model.compute_dtype = "float32"
    cfg.model.tracker.matcher_solver = "jv"
    cfg.test.window_size = 2
    images = next(synthetic_videos(1, 2, 512, 1024, 512, 1024, SEED + 3))["images"]
    out, launches = {}, {}
    with torch.inference_mode():
        for d in (dev, torch.device("cpu")):
            reset_launches()
            res = _online_video(cfg, build_model(cfg, d), images, cfg.test.window_size)
            out[d.type], launches[d.type] = [x.float().cpu() for x in res], read_launches()
    errs = {}
    for i, name in enumerate(("logits", "masks", "aux")):
        a, b = out["cuda"][i], out["cpu"][i]
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {name} on the GPU")
        errs[name] = ((a - b).abs().max() / b.abs().max()).item()
    emit({"phase": "vitl_slice_parity", "input": [2, 512, 1024], "tokens": 2049,
          "window": cfg.test.window_size, "rel_err": errs, "tol": SLICE_TOL, "launches": launches})
    if max(errs.values()) > SLICE_TOL:
        raise AssertionError(f"GPU ViT-L path disagrees with the CPU path: {errs}")
    if launches["cuda"]["flash_attn_fwd"] != cfg.model.backbone.vit_depth or any(launches["cpu"].values()):
        raise AssertionError(f"ViT-L parity run took the wrong attention path: {launches}")


def phase_vitl_slice(dev):
    """Full-width ViT-L DVIS++ offline over 2 videos x 10 frames of 720x1280
    padded to 736x1280, window 5: B3 runs once per trunk block and window,
    B1 once per pixel-decoder encoder layer and once per extractor (4
    interactions + 2 extra) and window. Then one further window with dense
    trunk attention on the same weights: its time, its peak memory, and the
    distances between the backbone's features on the kernel path, on the
    dense path and in an fp32 evaluation (relative RMS and largest
    difference over the feature maximum): the two bf16 paths must be as
    close to each other as each is to fp32."""
    import torch

    from dvis_plus_tpu_torch.engine.inference import _online_video
    from dvis_plus_tpu_torch.models.backbones.vit_adapter import Attention

    cfg = vitl_cfg()
    model = build_model(cfg, dev)
    res, rows_ok, _ = timed_slice(cfg, dev, frames=VIT_FRAMES, canvas=(VIT_H, VIT_W),
                               valid=(VIT_H_OUT, VIT_W_OUT), out=(VIT_H_OUT, VIT_W_OUT), model=model)
    windows = VIDEOS * -(-VIT_FRAMES // cfg.test.window_size)
    b = cfg.model.backbone
    extractors = len(b.vit_interaction_indexes) + 2
    expect = {"msdeform_fwd": (cfg.model.pixel_decoder.transformer_enc_layers + extractors) * windows,
              "swin_window_attn_fwd": 0, "flash_attn_fwd": b.vit_depth * windows}

    images = next(synthetic_videos(1, 5, VIT_H, VIT_W, VIT_H_OUT, VIT_W_OUT, SEED + 4))["images"]
    frames = torch.from_numpy(images).to(dev).permute(0, 3, 1, 2).to(torch.bfloat16)
    window = {}
    with torch.inference_mode():
        for impl in ("flash", "dense", "flash", "dense"):  # in turns; the second round is timed
            for m in model.modules():
                if isinstance(m, Attention):
                    m.attn_impl = impl
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            _online_video(cfg, model, images, 5)
            torch.cuda.synchronize()
            window[impl] = {"window_ms": 1e3 * (time.perf_counter() - t0),
                            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                            "flash_attn_fwd": read_launches()["flash_attn_fwd"],
                            "features": model.backbone(frames)}
        feats = {"flash": window["flash"].pop("features"), "dense": window["dense"].pop("features"),
                 "fp32": model.backbone(frames.float())}  # fp32 throughout, dense attention
    dists = {}
    for one, other in (("flash", "dense"), ("flash", "fp32"), ("dense", "fp32")):
        dist = dists[f"{one}_vs_{other}"] = {"rms": {}, "max": {}}
        for name, want in feats[other].items():
            got, want = feats[one][name].float(), want.float()
            if not torch.isfinite(got).all():
                raise AssertionError(f"non-finite {name} from the ViT-L backbone ({one})")
            dist["rms"][name] = ((got - want).norm() / want.norm()).item()
            dist["max"][name] = ((got - want).abs().max() / want.abs().max()).item()
    dist = dists["flash_vs_dense"]
    del feats
    res = {"phase": "vitl_slice", "backbone": b.name, "meta_architecture": cfg.model.meta_architecture,
           "vit_flash_attention": True, "valid": [VIT_H_OUT, VIT_W_OUT], **res,
           "expected_launches": expect, "one_window": window,
           "dense_vs_kernel_rel_err": dist, "kernel_vs_fp32_rel_err": dists["flash_vs_fp32"],
           "dense_vs_fp32_rel_err": dists["dense_vs_fp32"],
           "dense_tol": {"rms": DENSE_TOL, "max": DENSE_MAX_TOL}}
    emit(res)
    if not (rows_ok and res["launches"] == expect):
        raise AssertionError(f"ViT-L slice check failed: {res}")
    if window["dense"]["flash_attn_fwd"] != 0 or window["flash"]["flash_attn_fwd"] != b.vit_depth:
        raise AssertionError(f"the attention switch did not switch: {window}")
    for pair in ("flash_vs_dense", "flash_vs_fp32"):
        d = dists[pair]
        if max(d["rms"].values()) > DENSE_TOL or max(d["max"].values()) > DENSE_MAX_TOL:
            raise AssertionError(f"ViT-L backbone features disagree ({pair}): {d}")
    return res


# MinVIS, CTVIS and Video Mask2Former, each at the full width of its YAML
def arch_presets():
    from dvis_plus_tpu_torch.config import (
        ctvis_r50_ytvis19,
        minvis_r50_ytvis19,
        video_maskformer_r50_ytvis19,
    )

    return {"minvis": minvis_r50_ytvis19, "ctvis": ctvis_r50_ytvis19,
            "video_maskformer": video_maskformer_r50_ytvis19}


def expected_b1(cfg, frames=FRAMES, videos=VIDEOS):
    """B1 runs once per pixel-decoder encoder layer and forward: a forward
    per window for the per-frame models, one per video for the clip model."""
    forwards = videos if cfg.model.meta_architecture == "video_maskformer" else \
        videos * -(-frames // cfg.test.window_size)
    return {"msdeform_fwd": cfg.model.pixel_decoder.transformer_enc_layers * forwards,
            "swin_window_attn_fwd": 0, "flash_attn_fwd": 0}


def phase_minvis_slice_parity(dev):
    """MinVIS, CTVIS and Video Mask2Former at full width, fp32, exact JV
    matcher, on 7 frames at 128x160 with window 5 (two windows, the last
    ragged; one clip-joint forward for the clip model): the GPU (kernel B1,
    cuDNN) against the CPU (B1's plain version) on the video's logits and
    its (aligned) masks, same seeded weights."""
    import torch

    from dvis_plus_tpu_torch.engine.inference import _clipformer_video, _minvis_video

    images = next(synthetic_videos(1, 7, 128, 160, 128, 160, SEED + 5))["images"]
    for arch, preset in arch_presets().items():
        cfg = preset()
        cfg.model.compute_dtype = "float32"
        cfg.model.tracker.matcher_solver = "jv"
        fn = _clipformer_video if arch == "video_maskformer" else _minvis_video
        out, launches = {}, {}
        with torch.inference_mode():
            for d in (dev, torch.device("cpu")):
                reset_launches()
                logits, masks, _ = fn(cfg, build_model(cfg, d), images, cfg.test.window_size)
                out[d.type], launches[d.type] = (logits.float().cpu(), masks.float().cpu()), read_launches()
        errs = {}
        for i, name in enumerate(("logits", "masks")):
            a, b = out["cuda"][i], out["cpu"][i]
            if not torch.isfinite(a).all():
                raise AssertionError(f"non-finite {name} on the GPU ({arch})")
            errs[name] = ((a - b).abs().max() / b.abs().max()).item()
        expect = expected_b1(cfg, frames=7, videos=1)
        emit({"phase": "minvis_slice_parity", "arch": arch, "input": [7, 128, 160],
              "window": cfg.test.window_size, "masks_shape": list(out["cuda"][1].shape),
              "rel_err": errs, "tol": SLICE_TOL, "launches": launches, "expected_launches": expect})
        if max(errs.values()) > SLICE_TOL:
            raise AssertionError(f"GPU {arch} path disagrees with the CPU path: {errs}")
        if launches["cuda"] != expect or any(launches["cpu"].values()):
            raise AssertionError(f"{arch} parity run took the wrong path: {launches}")


def phase_arch_slice(dev, arch, phase):
    """Full-width ``arch`` over 2 videos x 15 frames at 480x640 (output
    720x960), bf16, at the JAX package's default eval settings: the ``runs``
    download, the threaded pipeline, the ``auction`` matcher."""
    cfg = arch_presets()[arch]()
    res, rows_ok, _ = timed_slice(cfg, dev)
    expect = expected_b1(cfg)
    res = {"phase": phase, "meta_architecture": arch, **res, "expected_launches": expect}
    emit(res)
    if not (rows_ok and res["launches"] == expect):
        raise AssertionError(f"{phase} check failed: {res}")
    return res


# the downloads compared by phase_download: the port's earlier post-processing
# (packed pixels, plain loop, numpy RLE), the same with the native codec, each
# download with and without the pipeline (runs + pipeline: the JAX defaults),
# and the defaults with one change row a column, which sends most frames to
# the packed fallback
DOWNLOADS = {
    "packed_plain_numpy_codec": dict(mask_download="packed", eval_pipeline=False),
    "packed_plain": dict(mask_download="packed", eval_pipeline=False),
    "packed_pipeline": dict(mask_download="packed", eval_pipeline=True),
    "runs_plain": dict(mask_download="runs", eval_pipeline=False),
    "runs_pipeline": dict(mask_download="runs", eval_pipeline=True),
    "runs_pipeline_k1": dict(mask_download="runs", eval_pipeline=True, rle_col_k=1),
}


def download_device_ms(dev):
    """Device time of one chunk's download pass (the slices' top-20 x 5
    frames of stride-4 logits, 120x160 -> 720x960) by download, on logits of
    two kinds: noise (a sign change every pixel or two) and smooth (noise at
    6x8, upsampled: a few boundaries a column, as a trained model's masks),
    with the frames that overflow ``rle_col_k=8``."""
    import torch
    import torch.nn.functional as F

    from dvis_plus_tpu_torch.engine.inference import _upsample_pack, _upsample_runs

    g = torch.Generator(device="cpu").manual_seed(SEED)
    sizes = ((H_IN, W_IN), (H_OUT, W_OUT), (H_IN, W_IN))
    noise = torch.randn(20, 5, H_IN // 4, W_IN // 4, generator=g)
    smooth = F.interpolate(torch.randn(20, 5, 6, 8, generator=g), size=noise.shape[-2:], mode="bilinear")
    out = {}
    for name, sel in (("noise", noise.to(dev)), ("smooth", smooth.to(dev))):
        runs = _upsample_runs(sel, *sizes, 8)
        out[name] = {"overflow_frames_k8": int((runs[..., 8].amax(-1) > 8).sum()), "frames": 100,
                     "packed_ms": cuda_ms(lambda: _upsample_pack(sel, *sizes), 20),
                     "runs_ms": cuda_ms(lambda: _upsample_runs(sel, *sizes, 8), 20)}
    return out


def phase_download(dev):
    """On the R50 online and the MinVIS paths (2 videos x 15 frames at
    480x640, output 720x960, bf16): every setting of ``DOWNLOADS`` writes the
    same results.json bytes; their ``post_s``, ``fps`` and ``model_fps``
    side by side, a record and no claim. ``packed_plain_numpy_codec`` swaps
    the native codec for its numpy twin for that run only. Then the device
    time of one chunk's download pass by download."""
    from dvis_plus_tpu_torch.config import dvis_online_r50_ytvis19, minvis_r50_ytvis19
    from dvis_plus_tpu_torch.utils import rle, rle_numpy

    for path, preset in (("slice", dvis_online_r50_ytvis19), ("minvis_slice", minvis_r50_ytvis19)):
        model = build_model(preset(), dev)
        runs, outputs = {}, {}
        for name, test in DOWNLOADS.items():
            cfg = preset()
            for k, v in test.items():
                setattr(cfg.test, k, v)
            native = rle.encode_packed
            if name.endswith("numpy_codec"):
                rle.encode_packed = rle_numpy.encode_packed
            try:
                res, rows_ok, outputs[name] = timed_slice(cfg, dev, model=model)
            finally:
                rle.encode_packed = native
            if not rows_ok:
                raise AssertionError(f"download {name} on {path}: malformed rows")
            runs[name] = {k: res[k] for k in ("post_s", "rows_s", "fps", "model_fps", "wall_s",
                                              "fallback_frames", "masks", "results_json_bytes")}
        equal = {name: out == outputs["packed_plain"] for name, out in outputs.items()}
        emit({"phase": "download", "path": path, "runs": runs, "same_bytes_as_packed_plain": equal})
        if not all(equal.values()):
            raise AssertionError(f"downloads disagree on {path}: {equal}")
    emit({"phase": "download", "device_ms_a_chunk": download_device_ms(dev)})


# VPS and VSS: the VIPSeg geometry (720x1280 frames on a 736x1280 canvas, ids
# written at 720x1280) and VSPW's (480x853 frames resized to 720x1280, class
# maps written at 480x853, so the second resize downsamples)
TASK_OUT = {"vps": (720, 1280), "vss": (480, 853)}
TASK_PIXEL_TOL = 0.999  # GPU against CPU: least share of equal pixels (id or class maps)


def task_cfg(task, arch="dvis_online"):
    from dvis_plus_tpu_torch.config import dvis_online_r50_vipseg, dvis_online_r50_vspw

    cfg = {"vps": dvis_online_r50_vipseg, "vss": dvis_online_r50_vspw}[task]()
    cfg.model.meta_architecture = arch
    return cfg


def task_videos(n, T, H, W, Ho, Wo, seed, valid=None):
    """``synthetic_videos`` with frame names, as the VPS and VSS evaluators
    name their PNGs by them."""
    for video in synthetic_videos(n, T, H, W, Ho, Wo, seed, valid):
        video["file_names"] = [f"{video['video_id']}/{t:05d}.jpg" for t in range(T)]
        yield video


def run_task(cfg, model, videos, evaluator, timings=None):
    from dvis_plus_tpu_torch.engine.inference import run_vps_inference, run_vss_inference

    if cfg.test.task == "vps":
        run_vps_inference(cfg, model, videos, evaluator, 58, timings)  # VIPSeg's thing classes
    else:
        run_vss_inference(cfg, model, videos, evaluator, timings)


class TaskRecorder:
    """Keeps what a VPS or VSS loop hands its evaluator, per video."""

    def __init__(self):
        self.maps, self.segments = [], []

    def process(self, video_id, frame_names, maps, segments_infos=None):
        self.maps.append(maps)
        self.segments.append(segments_infos)


def phase_vps_slice_parity(dev):
    """The full-width R50 VPS network (124 classes) at fp32 with the JV
    matcher, on 7 frames of 128x160 (window 5: two windows, the last
    ragged): the GPU (kernel B1, cuDNN) against the CPU (B1's plain version),
    same seeded weights, through ``run_vps_inference`` and
    ``run_vss_inference``: the panoptic id maps give the same (id, category,
    isthing) segments and agree on at least 99.9 % of the pixels, the VSS
    class maps too, and DVIS++ offline on VPS (the aux fusion) as well. Then
    on the GPU's own chunk outputs, the device segment bookkeeping against
    the plain host version: equal."""
    import torch

    from dvis_plus_tpu_torch.engine.inference import video_logits_masks
    from dvis_plus_tpu_torch.models.meta import dvis_online as heads

    rows = []
    for task, arch in (("vps", "dvis_online"), ("vss", "dvis_online"), ("vps", "dvis_offline")):
        cfg = task_cfg(task, arch)
        cfg.model.compute_dtype = "float32"
        cfg.model.tracker.matcher_solver = "jv"
        recs, launches = [], {}
        for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            recs.append(TaskRecorder())
            reset_launches()
            run_task(cfg, build_model(cfg, d), task_videos(1, 7, 128, 160, 128, 160, SEED + 6), recs[-1])
            launches[name] = read_launches()
        got, want = recs
        equal = float((got.maps[0] == want.maps[0]).mean())
        same_segments = got.segments == want.segments
        row = {"task": task, "arch": arch, "pixels_equal": equal, "same_segments": same_segments,
               "segments": None if task == "vss" else len(want.segments[0]),
               "classes": sorted(int(c) for c in np.unique(got.maps[0])) if task == "vss" else None,
               "launches": launches, "expected_launches": expected_b1(cfg, frames=7, videos=1)}
        rows.append(row)
        emit({"phase": "vps_slice_parity", "input": [7, 128, 160], "tol": TASK_PIXEL_TOL, **row})
        if equal < TASK_PIXEL_TOL or (task == "vps" and not same_segments):
            raise AssertionError(f"GPU {task} ({arch}) disagrees with the CPU: {row}")
        if launches["cuda"] != row["expected_launches"] or any(launches["cpu"].values()):
            raise AssertionError(f"{task} ({arch}) parity run took the wrong path: {launches}")

    # the bookkeeping alone, on the card's chunk outputs of one video
    cfg = task_cfg("vps")
    cfg.model.compute_dtype = "float32"
    cfg.model.tracker.matcher_solver = "jv"
    video = next(task_videos(1, 7, 128, 160, 128, 160, SEED + 6))
    with torch.inference_mode():
        logits, masks, aux = video_logits_masks(cfg, build_model(cfg, dev), video["images"], 5)
        geometry = ((128, 160), (128, 160), (128, 160))
        outs = [heads.panoptic_probs(logits, masks[:, s : s + 5], *geometry, 0.0, aux) for s in (0, 5)]
        seg, infos, kept = heads.panoptic_segments_device(*outs[0][:3], [o[3:] for o in outs], 58, 0.8)
        want = heads.panoptic_segments_host(
            *(x.cpu().numpy() for x in outs[0][:3]), torch.cat([o[3] for o in outs], 1).half().cpu().numpy(),
            torch.cat([o[4] for o in outs]).cpu().numpy(), 58, 0.8)
    equal = bool(np.array_equal(seg.cpu().numpy(), want[0]) and infos == want[1] and kept == want[2])
    emit({"phase": "vps_slice_parity", "bookkeeping": "device vs plain host", "equal": equal,
          "segments": len(infos)})
    if not equal:
        raise AssertionError("the device segment bookkeeping disagrees with the plain host version")
    return rows


def phase_task_slice(dev, task):
    """Full-width R50 DVIS++ online VPS (``dvis_online_r50_vipseg``) or VSS
    (``dvis_online_r50_vspw``), bf16 at the YAML's settings, 2 videos x 15
    frames of 720x1280 on a 736x1280 canvas (made before the timed run: the
    VPS and VSS loops, as the JAX package's, read the loader on the main
    thread), through ``run_vps_inference`` / ``run_vss_inference`` with the
    real evaluator writing its PNGs (and ``pred.json``) into a temporary
    directory, after one untimed warm-up video. Every frame's PNG must exist and decode (``utils.png.read_png``)
    to the map computed on the device; B1 runs 6 times a window."""
    import torch

    from dvis_plus_tpu_torch.evaluation.evaluators import VPSEvaluator, VSSEvaluator
    from dvis_plus_tpu_torch.utils.png import read_png

    cfg = task_cfg(task)
    model = build_model(cfg, dev)
    out = TASK_OUT[task]
    base = VPSEvaluator if task == "vps" else VSSEvaluator

    class Keeping(base):  # the maps handed over, to check the files against
        def __init__(self, *args):
            super().__init__(*args)
            self.kept = []

        def process(self, video_id, frame_names, maps, *rest):
            self.kept.append((video_id, frame_names, maps.copy(), *rest))
            super().process(video_id, frame_names, maps, *rest)

    canvas, valid = (VIT_H, VIT_W), (VIT_H_OUT, VIT_W_OUT)
    with tempfile.TemporaryDirectory() as tmp:
        run_task(cfg, model, task_videos(1, 5, *canvas, *out, 99, valid), base("warmup", tmp + "/w"))
        evaluator = Keeping("synthetic", tmp + "/run")
        timings = {}
        videos = list(task_videos(VIDEOS, FRAMES, *canvas, *out, SEED, valid))  # made before the clock
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        run_task(cfg, model, iter(videos), evaluator, timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        scores = evaluator.evaluate()
        files_ok = True
        for video_id, names, maps, *rest in evaluator.kept:
            for t, name in enumerate(names):
                stem = os.path.splitext(os.path.basename(name))[0] + ".png"
                path = os.path.join(tmp, "run", *(["pan_pred"] if task == "vps" else []), str(video_id), stem)
                if not os.path.exists(path):
                    files_ok = False
                    continue
                img = read_png(path).astype(np.int64)
                decoded = img[..., 0] + 256 * img[..., 1] + 65536 * img[..., 2] if task == "vps" else img
                files_ok &= bool(np.array_equal(decoded, maps[t].astype(np.int64)))
        pngs = sum(f.endswith(".png") for _, _, fs in os.walk(os.path.join(tmp, "run")) for f in fs)
        segments = [len(rest[0]) for _, _, _, *rest in evaluator.kept] if task == "vps" else None
        classes = [len(np.unique(m)) for _, _, m, *_ in evaluator.kept]
    expect = expected_b1(cfg)
    post = timings["post_s"]
    res = {"phase": f"{task}_slice", "meta_architecture": cfg.model.meta_architecture,
           "num_classes": cfg.model.num_classes, "compute_dtype": cfg.model.compute_dtype, "tf32": False,
           "videos": VIDEOS, "frames": FRAMES, "input": list(canvas), "valid": list(valid),
           "output": list(out), "window": cfg.test.window_size, "wall_s": wall,
           "fps": VIDEOS * FRAMES / wall, "model_fps": VIDEOS * FRAMES / timings["model_s"],
           "post_s": post, "post_split_s": {
               "device_pass": post - timings.get("segments_s", 0.0) - timings["png_s"],
               "host_bookkeeping": timings.get("segments_s", 0.0), "png_writes": timings["png_s"]},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "segments_per_video": segments,
           "classes_per_video": classes, "pngs": pngs, "files_match_device_maps": files_ok,
           "evaluate": scores, "launches": launches, "expected_launches": expect}
    emit(res)
    if not (files_ok and pngs == VIDEOS * FRAMES and res["launches"] == expect and res["evaluate"]["videos"] == VIDEOS):
        raise AssertionError(f"{task}_slice check failed: {res}")
    return res


# DVIS-DAQ. The seeded random heads (torch's initialisation) give every
# query of a frame nearly the same class scores, so the cutter's class head
# is scaled x8 with its no-object logit raised by 3, and the segmenter's
# no-object logit is raised by 7: the first frame starts no sequence (its
# validity is the segmenter's score against 0.01), the second starts as many
# as the table of 50 holds, and from then on the slot branch's scores of the
# live tracks sit a few thousandths from their threshold of 0.01, so some
# tracks miss frames and are kept (DAQ_HEADS: module, weight scale,
# no-object shift).
DAQ_HEADS = (("tracker.class_embed", 8.0, 3.0), ("sem_seg_head.predictor.class_embed", 1.0, 7.0))
# The GPU against CPU runs lower the cutter's no-object logit by 4 instead,
# so that every live track's slot-branch score sits far (0.17 and more)
# above its gate: the slot-to-query auction settles nearly tied assignments
# by the last bits of the costs, so the two devices may pair a slot with
# another of the segmenter's queries, which moves that slot's gate score.
DAQ_PARITY_HEADS = (("tracker.class_embed", 8.0, -4.0), ("sem_seg_head.predictor.class_embed", 1.0, 7.0))


def daq_model(cfg, dev, heads=DAQ_HEADS):
    import torch

    model = build_model(cfg, dev)
    with torch.no_grad():
        for name, scale, shift in heads:
            head = model.get_submodule(name)
            head.weight.mul_(scale)
            head.bias[-1] += shift
    return model


def daq_presets():
    from dvis_plus_tpu_torch.config import daq_offline_r50_ovis, daq_online_r50_ytvis19

    return {"daq_online": daq_online_r50_ytvis19, "daq_offline": daq_offline_r50_ovis}


def daq_vps_cfg():
    """DAQ online through the VPS loop at ``configs/daq/daq_online_r50_vipseg.yaml``'s
    settings: 124 classes, every threshold 0.01, no slot gate, sequences
    shorter than 5 frames that end early dropped."""
    cfg = daq_presets()["daq_online"]()
    m, d = cfg.model, cfg.model.daq
    m.num_classes = 124
    d.inference_select_thr = d.aux_inference_select_thr = d.training_select_thr = 0.01
    d.noise_frame_num, d.ovis_infer = 5, False
    cfg.test.task = "vps"
    return cfg


def daq_stream(cfg, model, images):
    """``stream_video`` with every frame's slot state and how far the
    scores that decide a live track's survival (the selection score, and
    the slot branch's against ``keep_threshold``) lie from their
    thresholds. Returns (records, [(alive, seq_id, invalid_frames) per
    frame, on the device], (T, (H4, W4), features), margins)."""
    from dvis_plus_tpu_torch.engine.daq_inference import stream_video

    d, cutter, states, margins = cfg.model.daq, model.tracker, [], {}
    step, pred, cls = cutter.inference_step, cutter._prediction, cutter._class_logits
    live = []

    def recording_step(state, *args, **kwargs):
        live[:] = [state.alive]
        out, state = step(state, *args, **kwargs)
        states.append((state.alive, state.seq_id, state.invalid_frames))
        return out, state

    def distance(logits, thr, key):
        alive = live[0][: cutter.num_track_slots]
        if alive.any():
            score = logits.float().softmax(-1)[: cutter.num_track_slots, :-1].max(-1).values
            margins[key] = min(margins.get(key, 1.0), float((score[alive] - thr).abs().min()))

    def recording_pred(h, mf):
        logits, masks = pred(h, mf)
        distance(logits, d.inference_select_thr, "select")
        return logits, masks

    def recording_cls(h):
        logits = cls(h)
        distance(logits, d.keep_threshold, "keep")
        return logits

    cutter.inference_step, cutter._prediction, cutter._class_logits = recording_step, recording_pred, recording_cls
    try:
        records, T, shape4, features = stream_video(cfg, model, images,
                                                    keep_features=cfg.model.meta_architecture == "daq_offline")
    finally:
        del cutter.inference_step, cutter._prediction, cutter._class_logits
    return records, states, (T, shape4, features), margins


def host_states(states):
    return [tuple(t.cpu().numpy() for t in s) for s in states]


def daq_events(states):
    """One video's frames of slot state on the host -> its sequences,
    those started after frame 0, those that left the table before the video
    ended (kick-outs), and live tracks kept through a miss (summed over
    frames)."""
    first, last = {}, {}
    for t, (alive, seq, _) in enumerate(states):
        for sid in seq[alive].tolist():
            first.setdefault(sid, t)
            last[sid] = t
    return {"sequences": len(first), "started_after_frame_0": sum(t > 0 for t in first.values()),
            "kicked_out": sum(t + 1 < len(states) for t in last.values()),
            "kept_through_a_miss": int(sum((a & (inv > 0)).sum() for a, _, inv in states))}


def phase_daq_slice_parity(dev):
    """DVIS-DAQ at full width (R50, Q = 100, 100 new-instance queries, a
    table of 50, 6-layer cutter), fp32, TF32 off, 7 frames at 128x160,
    window 5 (two windows, the last ragged): the GPU (kernel B1, cuDNN)
    against the CPU (B1's plain version), same seeded weights, the heads
    set by ``DAQ_PARITY_HEADS``.

    - online and offline: every frame's slot state (alive, seq ids,
      missed-frame counts) equal (the line gives how far the CPU's scores
      that decide a live track's survival lie from their thresholds: a
      flip within the GPU's rounding would be no fault), the same
      sequences on the same frames,
      their logits and embeds within SLICE_TOL, their fp16 masks within
      SLICE_TOL of the largest; offline, the refiner's logits and masks of
      each sequence too. The random model's sequences score alike to 1e-7,
      so a top-20 cut would pick rows by rounding: the offline run refines
      all of them (``offline_topk_num`` 50) and compares them by sequence.
    - DAQ through ``run_vps_inference`` (124 classes): at least 99.9 % of
      the id-map pixels equal, the same segments.
    - ``_vos_output`` fed given objects directly (three sequences' masks of
      frame 1, upsampled; the video from frame 1 on, since frame 0 starts no
      sequence) on each device's sequences: the label PNGs, written without
      OpenCV and read back, give the same foreground on at least 99.9 % of
      the pixels, with the given objects' labels. Which object a foreground
      pixel takes is the argmax of the objects' logits, which the random
      model makes nearly equal, so rounding decides it: the line gives the
      share of equal labels, which no bar holds."""
    import torch

    from dvis_plus_tpu_torch.engine import daq_inference as daq
    from dvis_plus_tpu_torch.utils.png import read_png

    images = next(synthetic_videos(1, 7, 128, 160, 128, 160, SEED + 7))["images"]
    rows, seqs = [], {}
    for arch, preset in daq_presets().items():
        cfg = preset()
        cfg.model.compute_dtype = "float32"
        cfg.model.daq.offline_topk_num = 50
        out, launches = {}, {}
        with torch.inference_mode():
            for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
                model = daq_model(cfg, d, DAQ_PARITY_HEADS)
                reset_launches()
                records, states, (T, shape4, features), margins = daq_stream(cfg, model, images)
                states = host_states(states)
                pred_cls, masks, embeds, _, ids = daq.collect_sequences(cfg, records, T, shape4)
                refined = None
                if arch == "daq_offline":
                    order = np.argsort(-daq._softmax(pred_cls)[:, :-1].max(axis=1))
                    r_cls, r_masks = daq._offline_refine(cfg, model, pred_cls, embeds, features)
                    refined = {ids[i]: (r_cls[j], r_masks[j]) for j, i in enumerate(order)}
                launches[name] = read_launches()
                out[name] = (records, states, dict(zip(ids, zip(pred_cls, masks))), refined, margins)
        got, want = out["cuda"], out["cpu"]
        states_equal = len(got[1]) == len(want[1]) == 7 and all(
            all(np.array_equal(a, b) for a, b in zip(g, w)) for g, w in zip(got[1], want[1]))
        same = sorted(got[0]) == sorted(want[0]) and all(
            got[0][k].frames == want[0][k].frames for k in want[0])
        errs = {}
        if same:
            def rel(pairs):
                a = np.stack([p[0] for p in pairs]).astype(np.float32)
                b = np.stack([p[1] for p in pairs]).astype(np.float32)
                return float(np.abs(a - b).max() / np.abs(b).max())

            keys = sorted(want[0])
            for field in ("logits", "embeds", "masks"):
                errs[field] = rel([(np.stack(getattr(got[0][k], field)), np.stack(getattr(want[0][k], field)))
                                   for k in keys])
            if want[3] is not None:
                errs["refined_logits"] = rel([(got[3][k][0], want[3][k][0]) for k in keys])
                errs["refined_masks"] = rel([(got[3][k][1], want[3][k][1]) for k in keys])
        expect = expected_b1(cfg, frames=7, videos=1)
        row = {"phase": "daq_slice_parity", "arch": arch, "input": [7, 128, 160],
               "window": cfg.test.window_size, "states_equal": states_equal, "same_sequences": same,
               "cpu_threshold_margins": want[4],
               "events": daq_events(want[1]), "rel_err": errs, "tol": SLICE_TOL,
               "launches": launches, "expected_launches": expect}
        rows.append(row)
        emit(row)
        if not (states_equal and same and errs and max(errs.values()) <= SLICE_TOL):
            raise AssertionError(f"GPU {arch} disagrees with the CPU: {row}")
        if launches["cuda"] != expect or any(launches["cpu"].values()):
            raise AssertionError(f"{arch} parity run took the wrong path: {launches}")
        seqs[arch] = (got[2], want[2])

    # DAQ through the VPS loop
    cfg = daq_vps_cfg()
    cfg.model.compute_dtype = "float32"
    recs, launches = [], {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        recs.append(TaskRecorder())
        reset_launches()
        run_task(cfg, daq_model(cfg, d, DAQ_PARITY_HEADS), task_videos(1, 7, 128, 160, 128, 160, SEED + 7),
                 recs[-1])
        launches[name] = read_launches()
    got, want = recs
    row = {"phase": "daq_slice_parity", "task": "vps", "input": [7, 128, 160],
           "pixels_equal": float((got.maps[0] == want.maps[0]).mean()),
           "same_segments": got.segments == want.segments, "segments": len(want.segments[0]),
           "tol": TASK_PIXEL_TOL, "launches": launches}
    emit(row)
    if row["pixels_equal"] < TASK_PIXEL_TOL or not row["same_segments"]:
        raise AssertionError(f"GPU DAQ VPS disagrees with the CPU: {row}")

    # the VOS writer on given objects, frames 1-6 of the online sequences
    cfg = daq_presets()["daq_online"]()
    online_got, online_want = seqs["daq_online"]
    keys = sorted(online_want)[:3]
    gt = np.stack([np.kron(online_want[k][1][1].astype(np.float32) > 0, np.ones((4, 4))) > 0 for k in keys])
    pngs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, seq in (("cuda", online_got), ("cpu", online_want)):
            cfg.output_dir = os.path.join(tmp, name)
            ks = sorted(seq)
            sample = {"images": images[1:], "image_size": [128, 160], "height": 128, "width": 160,
                      "video_name": "v", "file_names": [f"v/{t:05d}.jpg" for t in range(6)],
                      "first_frame_masks": gt, "first_frame_ids": [1, 2, 3]}
            daq._vos_output(cfg, sample, np.stack([seq[k][0] for k in ks]),
                            np.stack([seq[k][1][1:] for k in ks]))
            pngs[name] = [read_png(os.path.join(cfg.output_dir, "inference", "v", f"{t:05d}.png"))
                          for t in range(6)]
    got, want = np.stack(pngs["cuda"]), np.stack(pngs["cpu"])
    row = {"phase": "daq_slice_parity", "task": "vos", "pngs": len(got),
           "foreground_equal": float(((got > 0) == (want > 0)).mean()),
           "labels_equal": float((got == want).mean()),
           "labels": sorted(int(v) for v in np.unique(got)), "tol": TASK_PIXEL_TOL}
    emit(row)
    if row["foreground_equal"] < TASK_PIXEL_TOL or not set(row["labels"]) <= {0, 1, 2, 3} \
            or len(row["labels"]) < 3:
        raise AssertionError(f"VOS label maps of the GPU sequences disagree with the CPU's: {row}")
    return rows


def phase_daq_slice(dev, arch, phase):
    """Full-width DVIS-DAQ (``daq_online_r50_ytvis19``, or
    ``daq_offline_r50_ovis``: the refiner over the 20 best sequences) in
    bf16 over 2 videos x 15 frames at 480x640, output 720x960, through
    ``run_vis_inference`` (the DAQ loop: no pipeline, the ``runs``
    download), after one untimed warm-up video. The timed run also counts
    its host syncs (PyTorch's sync debug mode, plus the waits on the events
    of the window reads and downloads) and keeps every frame's slot state on
    the device, for each video's bookkeeping events. B1 runs 6 times a
    window: the offline pass reuses the streaming pass's frame queries and
    mask features."""
    import torch

    cfg = daq_presets()[arch]()
    model = daq_model(cfg, dev)
    cutter, states, waits = model.tracker, [], [0]
    step, synchronize = cutter.inference_step, torch.cuda.Event.synchronize

    def recording_step(*args, **kwargs):
        out, state = step(*args, **kwargs)
        states.append((state.alive, state.seq_id, state.invalid_frames))
        return out, state

    def counting(event):
        waits[0] += 1
        return synchronize(event)

    @contextlib.contextmanager
    def counted():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cutter.inference_step, torch.cuda.Event.synchronize = recording_step, counting
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.Event.synchronize = synchronize
                del cutter.inference_step
            waits.append(sum("synchroniz" in str(w.message) for w in caught))

    res, rows_ok, _ = timed_slice(cfg, dev, model=model, around=counted)
    expect = expected_b1(cfg)
    host = host_states(states)
    syncs = waits[0] + waits[1]
    res = {"phase": phase, "meta_architecture": arch, "table": cfg.model.daq.max_num_instances,
           "new_instance_queries": cfg.model.daq.num_new_ins, **res,
           "eval_pipeline": "none: the DAQ loop is plain, as in the JAX package",
           "host_syncs": {"total": syncs, "per_frame": syncs / (VIDEOS * FRAMES), "event_waits": waits[0]},
           "events_per_video": [daq_events(host[v * FRAMES : (v + 1) * FRAMES]) for v in range(VIDEOS)],
           "expected_launches": expect}
    emit(res)
    if not (rows_ok and res["launches"] == expect and len(host) == VIDEOS * FRAMES):
        raise AssertionError(f"{phase} check failed: {res}")
    return res

# ---------------------------------------------------------------------------
# Open vocabulary (OV-DVIS++): the CLIP ConvNeXt-L trunk, the FC-CLIP
# decoder, the OV tracker / refiner heads and the geometric ensemble
# ---------------------------------------------------------------------------

# the text tower of the ConvNeXt-L CLIP model (open_clip convnext_large_d_320:
# width 768, 12 heads, 16 layers, CLIP's vocabulary and context), seeded
TEXT_TOWER = dict(vocab_size=49408, context_length=77, width=768, heads=12, layers=16, embed_dim=768)
OV_LOGIT_SCALE = 4.0  # every logit_scale of the random models: exp(4) = 54.6, scores spread


def ov_presets():
    from dvis_plus_tpu_torch.config import (
        ov_minvis_convnextl_zeroshot_ytvis19,
        ov_offline_convnextl_zeroshot_ytvis19,
        ov_online_convnextl_zeroshot_ytvis19,
    )

    return {"dvis_online_ov": ov_online_convnextl_zeroshot_ytvis19,
            "minvis_ov": ov_minvis_convnextl_zeroshot_ytvis19,
            "dvis_offline_ov": ov_offline_convnextl_zeroshot_ytvis19}


def ov_model(cfg, dev):
    """The seeded random OV model of ``cfg`` on ``dev``: ConvNeXt layer
    scales 0.1 (a trained checkpoint's order, not the 1e-6 initial value, so
    that the trunk's blocks carry weight) and every ``logit_scale`` at
    ``OV_LOGIT_SCALE``."""
    import torch

    from dvis_plus_tpu_torch.cli_ov import build_ov_model

    torch.manual_seed(SEED)
    model = build_ov_model(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma") and "clip_model" in name:
                p.fill_(0.1)
            elif name.endswith("logit_scale"):
                p.fill_(OV_LOGIT_SCALE)
    return model.to(dev).eval()


def ov_classifier(dev):
    """The YouTube-VIS 2019 test classifier (40 classes x 14 templates, each
    the mean of its normalized synonym embeddings, ``models/ov/text.py``)
    from the seeded full-width random text tower on the card, fed seeded
    token ids (no tokenizer: a prompt's ids are drawn from its crc32, 6 to
    20 of them, the end-of-text id last and highest), and the seen mask
    against the COCO panoptic vocabulary (the zero-shot models' training
    set). Returns (classifier (R, 768) float32, num_templates, overlap (40,),
    build seconds, prompts encoded)."""
    import zlib

    import torch

    from dvis_plus_tpu_torch.cli_ov import VOCAB_DIR, _VOCAB_BY_DATASET
    from dvis_plus_tpu_torch.models.ov.clip_backbone import CLIPTextEncoder
    from dvis_plus_tpu_torch.models.ov.text import (
        build_text_classifier,
        category_overlapping_mask,
        load_vocabulary_file,
    )

    def vocab(prefix):
        classes = load_vocabulary_file(os.path.join(VOCAB_DIR, _VOCAB_BY_DATASET[prefix]))
        return classes[1:] if classes[0] == ["invalid_class_id"] else classes

    torch.manual_seed(SEED + 7)
    enc = CLIPTextEncoder(**TEXT_TOWER).to(dev).eval()
    eot = TEXT_TOWER["vocab_size"] - 1
    count = [0]

    def encode(prompts):
        tokens = np.zeros((len(prompts), TEXT_TOWER["context_length"]), np.int64)
        for i, p in enumerate(prompts):
            rng = np.random.RandomState(zlib.crc32(p.encode()))
            n = rng.randint(6, 21)
            tokens[i, 0] = eot - 1  # start of text
            tokens[i, 1:n] = rng.randint(1, eot - 1, size=n - 1)
            tokens[i, n] = eot
        count[0] += len(prompts)
        with torch.inference_mode():
            return enc(torch.from_numpy(tokens).to(dev)).float().cpu().numpy()

    test_classes = vocab("ytvis_2019")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tc, nt = build_text_classifier(encode, test_classes)
    seconds = time.perf_counter() - t0
    overlap = category_overlapping_mask(vocab("coco"), test_classes)
    return tc, nt, overlap, seconds, count[0]


def ov_video(cfg, model, images, classifier):
    """One video through the port's OV loop: (fused log-probs (Q, K+1),
    masks (Q, T, H4, W4), the CLIP embeddings ``pool_clip`` gave, the masks
    it thresholded)."""
    import torch

    from dvis_plus_tpu_torch.engine.ov_inference import ov_video_logits_masks_fn

    tc, nt, overlap = classifier[:3]
    pooled, pooled_masks = [], []
    pool = model.pool_clip

    def recording_pool(dense, masks):
        out = pool(dense, masks)
        pooled.append(out.float().cpu())
        pooled_masks.append(masks.float().cpu())
        return out

    model.pool_clip = recording_pool
    try:
        logits, masks = ov_video_logits_masks_fn(cfg, model, tc, nt, overlap)(images)
    finally:
        del model.pool_clip
    return logits, masks, torch.cat(pooled), torch.cat(pooled_masks)


def replay_attention(predictor, decisions, replay):
    """Wrap the query decoder's heads: record each layer's additive
    attention mask into ``decisions`` (``replay`` False), or replace the
    mask by the recorded one, in the same order (``replay`` True). Returns
    the running counts: calls, keys whose recorded decision the run would
    have made otherwise, keys, and the least |resized mask logit| it
    thresholded."""
    import torch.nn.functional as F

    heads = predictor._prediction_heads
    stats = {"calls": 0, "differ": 0, "keys": 0, "margin": float("inf")}

    def call(output, mask_features, attn_size):
        x, masks, additive = heads(output, mask_features, attn_size)
        am = F.interpolate(masks, size=attn_size, mode="bilinear", align_corners=False)
        stats["margin"] = min(stats["margin"], am.abs().min().item())
        if replay:
            ref = decisions[stats["calls"]].to(additive.device)
            stats["differ"] += int((ref != additive).sum())
            stats["keys"] += additive.numel()
            additive = ref
        else:
            decisions.append(additive.cpu())
        stats["calls"] += 1
        return x, masks, additive

    predictor._prediction_heads = call
    return stats


def phase_ov_slice_parity(dev, classifier):
    """The three OV architectures (ConvNeXt-L, full width) in fp32, exact JV
    matcher, on 7 frames at 128x160 with window 5 (two windows, the last
    ragged): the GPU (kernel B1, cuDNN) against the CPU (B1's plain version)
    on the fused log-probs, the masks, the pooled CLIP embeddings and the
    top-20 labels, same seeded weights and classifier.

    The query decoder's masked attention blocks a key where the resized
    mask logit is below 0; with random weights some of the hundreds of
    thousands of logits a window thresholds lie within 1e-7 of 0, under the
    two devices' fp32 difference (about 1e-6 of the pixel decoder's
    outputs), and one flipped key moves its query's embedding by 1e-3 (on
    an NVIDIA H100 80GB HBM3 at 700 W, without the replay: the decoder's
    embeds 4.5e-3 apart at a CPU margin of 1.6e-7, while the trunk and the
    pixel decoder agreed to 2.6e-6). So the CPU
    runs first and the card replays its attention decisions: the comparison
    holds the arithmetic of the same decisions, and the line counts the keys
    the card would have decided otherwise (``attention``). It also gives the
    least |value| the CPU thresholded into the pooled sets (the masks at
    stride 4 and their resize onto the stride-32 CLIP map)."""
    import torch

    from dvis_plus_tpu_torch.models.meta.minvis import topk_select
    from dvis_plus_tpu_torch.models.ov.heads import resize_masks

    images = next(synthetic_videos(1, 7, 128, 160, 128, 160, SEED + 8))["images"]
    results, faults = {}, []
    for arch, preset in ov_presets().items():
        cfg = preset()
        cfg.model.compute_dtype = "float32"
        cfg.model.tracker.matcher_solver = "jv"
        out, launches, attention, decisions = {}, {}, {}, []
        with torch.inference_mode():
            for d in (torch.device("cpu"), dev):
                model = ov_model(cfg, d)
                predictor = model.sem_seg_head.predictor
                attention[d.type] = replay_attention(predictor, decisions, replay=d.type == "cuda")
                reset_launches()
                try:
                    res = ov_video(cfg, model, images, classifier)
                finally:
                    del predictor._prediction_heads
                out[d.type], launches[d.type] = [x.float().cpu() for x in res], read_launches()
        errs = {}
        for i, name in enumerate(("log_probs", "masks", "pooled_clip")):
            a, b = out["cuda"][i], out["cpu"][i]
            if not torch.isfinite(a).all():
                raise AssertionError(f"non-finite {name} on the GPU ({arch})")
            errs[name] = ((a - b).abs().max() / b.abs().max()).item()
        labels = [topk_select(out[k][0], cfg.test.max_num)[1].tolist() for k in ("cuda", "cpu")]
        cpu_masks = out["cpu"][3]
        margins = {"stride4": cpu_masks.abs().min().item(),
                   "stride32": resize_masks(cpu_masks, (4, 5)).abs().min().item()}
        card = attention["cuda"]
        expect = expected_b1(cfg, frames=7, videos=1)
        emit({"phase": "ov_slice_parity", "arch": arch, "input": [7, 128, 160],
              "window": cfg.test.window_size, "queries": cfg.model.transformer_decoder.num_queries,
              "rel_err": errs, "tol": SLICE_TOL, "labels_equal": labels[0] == labels[1],
              "labels": sorted(set(labels[1])), "threshold_margin": margins,
              "attention": {"layers_replayed": card["calls"], "keys": card["keys"],
                            "keys_the_card_decides_otherwise": card["differ"],
                            "cpu_margin": attention["cpu"]["margin"]},
              "launches": launches, "expected_launches": expect})
        if max(errs.values()) > SLICE_TOL or labels[0] != labels[1]:
            faults.append(f"GPU {arch} path disagrees with the CPU path: {errs}, {labels}")
        if launches["cuda"] != expect or any(launches["cpu"].values()):
            faults.append(f"{arch} parity run took the wrong path: {launches}")
        if card["calls"] != attention["cpu"]["calls"]:
            faults.append(f"{arch}: the card ran {card['calls']} decoder layers, the CPU "
                          f"{attention['cpu']['calls']}")
        results[arch] = errs
    if faults:
        raise AssertionError("; ".join(faults))
    return results


@contextlib.contextmanager
def counting_syncs(counts):
    """Count host synchronizations: PyTorch's sync debug warnings plus the
    waits on CUDA events (the window reads and downloads), appended to
    ``counts`` as [event waits, debug-mode syncs]."""
    import torch

    synchronize, waits = torch.cuda.Event.synchronize, [0]

    def counting(event):
        waits[0] += 1
        return synchronize(event)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.Event.synchronize = counting
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.Event.synchronize = synchronize
    counts += [waits[0], sum("synchroniz" in str(w.message) for w in caught)]


def phase_ov_slice(dev, arch, phase, classifier):
    """Full-width OV-DVIS++ (``ov_online_convnextl_zeroshot_ytvis19`` or the
    offline YAML) in bf16 over 2 videos x 15 frames at 480x640, output
    720x960, at the default eval settings (the ``runs`` download, the
    pipeline) through ``run_ov_inference`` and the real YTVISEvaluator,
    after an untimed warm-up video; the text classifier of
    :func:`ov_classifier`. An untimed pass of the same videos then counts
    host syncs a frame. B1 runs 6 times a window: the offline refiner pass
    reuses the streaming pass's mask features."""
    import torch

    from dvis_plus_tpu_torch.engine.ov_inference import run_ov_inference

    cfg = ov_presets()[arch]()
    model = ov_model(cfg, dev)
    tc, nt, overlap, build_s, prompts = classifier

    def run(cfg, model, loader, evaluator, timings=None):
        run_ov_inference(cfg, model, loader, evaluator, tc, nt, overlap, timings=timings)

    res, rows_ok, _ = timed_slice(cfg, dev, model=model, run=run)
    counts = []
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode(), counting_syncs(counts):
        from dvis_plus_tpu_torch.evaluation.evaluators import YTVISEvaluator

        run(cfg, model, synthetic_videos(VIDEOS, FRAMES, H_IN, W_IN, H_OUT, W_OUT, SEED),
            YTVISEvaluator("syncs", tmp))
    expect = expected_b1(cfg)
    syncs = sum(counts)
    res = {"phase": phase, "meta_architecture": arch, "classes": len(nt) - 1,
           "classifier_rows": int(tc.shape[0]), "text_classifier_s": build_s, "prompts": prompts,
           **res, "host_syncs": {"total": syncs, "per_frame": syncs / (VIDEOS * FRAMES),
                                 "event_waits": counts[0]},
           "expected_launches": expect}
    emit(res)
    if not (rows_ok and res["launches"] == expect):
        raise AssertionError(f"{phase} check failed: {res}")
    return res


def phase_profile(dev, name):
    """One video of slice ``name`` (``vitl``: 5 frames at 736x1280, one
    window; ``swinl``, ``r50`` and ``ov`` (OV-DVIS++ online, ConvNeXt-L):
    15 frames at 480x640, three windows; ``daq``: DVIS-DAQ online's
    streaming pass over 5 frames at 480x640), bf16: CUDA-event time of
    every stage (device work plus dispatch gaps), then ``torch.profiler``
    over the same video: the device-busy share (sum of kernel times over
    wall) and the time by kernel and by operator."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dvis_plus_tpu_torch.config import dvis_offline_swinl_ytvis19, dvis_online_r50_ytvis19
    from dvis_plus_tpu_torch.engine.daq_inference import stream_video
    from dvis_plus_tpu_torch.engine.inference import _online_video

    cfg = {"vitl": vitl_cfg, "swinl": dvis_offline_swinl_ytvis19, "r50": dvis_online_r50_ytvis19,
           "daq": daq_presets()["daq_online"], "ov": ov_presets()["dvis_online_ov"]}[name]()
    # DAQ: one window, since the random model's slot auctions run 1,000 and
    # more bidding rounds of about 25 launches a frame
    T, H, W = (5, VIT_H, VIT_W) if name == "vitl" else (5, H_IN, W_IN) if name == "daq" else (FRAMES, H_IN, W_IN)
    model = daq_model(cfg, dev) if name == "daq" else ov_model(cfg, dev) if name == "ov" else \
        build_model(cfg, dev)
    images = next(synthetic_videos(1, T, H, W, H, W, SEED + 4))["images"]
    head = model.sem_seg_head
    stages = [("backbone", model.backbone, "forward"), ("pixel_decoder", head.pixel_decoder, "forward"),
              ("query_decoder", head.predictor, "forward")]
    if name == "daq":  # the cutter's step and three of its parts
        stages += [("cutter_step", model.tracker, "inference_step"),
                   ("cutter_decode", model.tracker, "_decode"),
                   ("slot_auction", model.tracker, "_match_slots_to_seg"),
                   ("slot_decode", model.tracker, "_slot_decode")]
    else:
        stages.append(("tracker", model.tracker, "forward"))
    if name == "ov":  # the out-of-vocabulary head: mask pooling + MLP into CLIP space
        from dvis_plus_tpu_torch.engine.ov_inference import ov_video_logits_masks_fn

        stages.append(("clip_pool", model.backbone, "pool_clip"))
        tc, nt, overlap = ov_classifier(dev)[:3]
        ov_fn = ov_video_logits_masks_fn(cfg, model, tc, nt, overlap)
    if hasattr(model, "refiner"):
        stages += [("refiner_embed_pass", model.refiner, "embed_pass"),
                   ("refiner_mask_window", model.refiner, "mask_window")]
    if name == "vitl":
        stages += [("vit_trunk_blocks", blk, "forward") for blk in model.backbone.vit_module.blocks]
    events = {}

    def timed(stage, fn):
        def call(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            events.setdefault(stage, []).append((a, b))
            return out

        return call

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "daq":
            stream_video(cfg, model, images)
        elif name == "ov":
            ov_fn(images)
        else:
            _online_video(cfg, model, images, cfg.test.window_size)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    with torch.inference_mode():
        run()  # warm-up
        plain_ms = run()
        for stage, obj, attr in stages:  # an instance attribute shadows the method
            setattr(obj, attr, timed(stage, getattr(obj, attr)))
        staged_ms = run()
        for _, obj, attr in stages:
            delattr(obj, attr)
        stage_ms = {k: sum(a.elapsed_time(b) for a, b in ev) for k, ev in events.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_ms = run()

    def self_device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # kernel rows carry the device time once; operator rows repeat it
    averages = prof.key_averages()
    kernels = sorted(((self_device_us(e), e.count, e.key) for e in averages
                      if e.device_type == DeviceType.CUDA), reverse=True)
    ops = sorted(((self_device_us(e), e.count, e.key) for e in averages
                  if e.device_type == DeviceType.CPU and self_device_us(e) > 0), reverse=True)
    device_ms = sum(r[0] for r in kernels) / 1e3
    if device_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time")

    def share(tag):
        rows = [r for r in kernels if tag in r[2]]
        ms = sum(r[0] for r in rows) / 1e3
        return {"ms": ms, "launches": sum(r[1] for r in rows), "share_of_device": ms / device_ms}

    def top(rows):
        return [{"ms": r[0] / 1e3, "count": r[1], "name": r[2][:72]} for r in rows[:10]]

    emit({"phase": "profile", "slice": name, "frames": T, "input": [H, W],
          "window": cfg.test.window_size, "compute_dtype": cfg.model.compute_dtype,
          "video_ms": {"plain": plain_ms, "staged": staged_ms, "profiled": profiled_ms},
          "stage_ms": stage_ms, "device_ms": device_ms,
          "busy_share": {"of_profiled_wall": device_ms / profiled_ms, "of_plain_wall": device_ms / plain_ms},
          "kernel_launches": sum(r[1] for r in kernels),
          "flash_attn_fwd": share("flash_attn"), "msdeform_fwd": share("msdeform_fwd"),
          "swin_window_attn_fwd": share("swin_window_attn"),
          "top_kernels": top(kernels), "top_operators": top(ops)})


def phase_host_syncs(dev):
    """Host synchronizations per frame on the main path (the auction
    matcher's round checks and the per-window reads), counted by PyTorch's
    sync debug mode over one 5-frame window."""
    import torch

    from dvis_plus_tpu_torch.config import dvis_online_r50_ytvis19
    from dvis_plus_tpu_torch.engine.inference import _online_video

    cfg = dvis_online_r50_ytvis19()
    model = build_model(cfg, dev)
    images = next(synthetic_videos(1, 5, H_IN, W_IN, H_OUT, W_OUT, SEED))["images"]
    with torch.inference_mode():
        _online_video(cfg, model, images, 5)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _online_video(cfg, model, images, 5)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    n = sum("synchroniz" in str(w.message) for w in caught)
    emit({"phase": "host_syncs", "frames": 5, "syncs": n, "per_frame": n / 5})


def main() -> int:
    import torch

    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import dvis_plus_tpu_torch  # noqa: F401  (fails outside a repository checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = phase_device()
    phase_build()
    if "--profile" in sys.argv[1:]:
        names = [a for a in sys.argv[1:] if a != "--profile"] or ["vitl", "swinl", "r50"]
        for name in names:
            phase_profile(dev, name)
        return 0
    if "--b1-runs" in sys.argv[1:]:
        phase_b1_runs(dev)
        return 0
    if "--daq" in sys.argv[1:]:
        phase_daq_slice_parity(dev)
        phase_daq_slice(dev, "daq_online", "daq_slice")
        phase_daq_slice(dev, "daq_offline", "daq_offline_slice")
        return 0
    if "--ov" in sys.argv[1:]:
        classifier = ov_classifier(dev)
        phase_ov_slice_parity(dev, classifier)
        phase_ov_slice(dev, "dvis_online_ov", "ov_slice", classifier)
        phase_ov_slice(dev, "dvis_offline_ov", "ov_offline_slice", classifier)
        emit({"phase": "wall", "seconds": time.perf_counter() - start})
        return 0
    b1, b2, b3 = phase_kernels(dev)
    phase_host_call(dev)
    if "--kernels" in sys.argv[1:]:
        return 0
    phase_slice_parity(dev)
    runs = {impl: phase_slice(dev, impl) for impl in ("exact", "pallas_local")}
    phase_host_syncs(dev)
    phase_swinl_slice_parity(dev)
    swinl = phase_swinl_slice(dev)
    phase_vitl_slice_parity(dev)
    vitl = phase_vitl_slice(dev)
    phase_minvis_slice_parity(dev)
    minvis = phase_arch_slice(dev, "minvis", "minvis_slice")
    clip = phase_arch_slice(dev, "video_maskformer", "clip_slice")
    phase_download(dev)
    phase_vps_slice_parity(dev)
    vps = phase_task_slice(dev, "vps")
    vss = phase_task_slice(dev, "vss")
    phase_daq_slice_parity(dev)
    daq_online = phase_daq_slice(dev, "daq_online", "daq_slice")
    daq_offline = phase_daq_slice(dev, "daq_offline", "daq_offline_slice")
    classifier = ov_classifier(dev)
    phase_ov_slice_parity(dev, classifier)
    ov_online = phase_ov_slice(dev, "dvis_online_ov", "ov_slice", classifier)
    ov_offline = phase_ov_slice(dev, "dvis_offline_ov", "ov_offline_slice", classifier)

    # the timed forms: B1 exact fp32 (R50 / Swin-L encoder shape; the ViT-L
    # slice's two shapes stand beside it under "by_shape"); B2 Swin-L stage 2
    # (18 of its 24 launches a window) with the shift mask in bf16, the
    # serving dtype, with every stage, shifted and not, under "by_shape"; B3
    # at the ViT-L trunk's serving shape in bf16, q/k/v as views of the fused
    # qkv output, with the shorter lengths under "by_shape"
    def b1_form(forms, offsets, dtype="float32", radius=None):
        return next(f for f in forms if f["offsets"] == offsets and f["value_dtype"] == dtype
                    and f["radius"] == radius)

    b1_main = b1_form(b1["encoder"], "uniform")
    b1_shapes = {}
    for offsets in ("uniform", "init"):
        tag = "" if offsets == "uniform" else "_init_offsets"
        b1_shapes["encoder_480x640" + tag] = b1_form(b1["encoder"], offsets)
        b1_shapes["encoder_480x640_clamped_r7" + tag] = b1_form(b1["encoder"], offsets, radius=7)
        b1_shapes["vitl_encoder_736x1280" + tag] = b1_form(b1["vitl_encoder"], offsets)
        b1_shapes["vitl_extractor" + tag] = b1_form(b1["vitl_extractor"], offsets, "bfloat16")
    b1_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "gathered_bytes",
               "gathered_tb_per_s", "out_dtype")
    timing_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    b2_shapes = {f"stage{f['stage']}_{'shifted' if f['nW'] else 'unshifted'}": f
                 for f in b2 if f["dtype"] == "bfloat16"}
    b2_main = b2_shapes["stage2_shifted"]
    # the Swin-L path's launches at each of those shapes, as that run counted them
    b2_counted = {(f["B_"], f["heads"], f["masked"]): f["launches"] for f in swinl["b2_launches_by_shape"]}
    b3_shapes = {f"B{f['B']}_L{f['L']}": f for f in b3
                 if f["dtype"] == "bfloat16" and f["layout"] == "fused_qkv_views"}
    b3_main = b3_shapes["B5_L3681"]
    paths = {"slice": runs["exact"], "swinl_slice": swinl, "vitl_slice": vitl,
             "minvis_slice": minvis, "clip_slice": clip, "vps_slice": vps, "vss_slice": vss,
             "daq_slice": daq_online, "daq_offline_slice": daq_offline,
             "ov_slice": ov_online, "ov_offline_slice": ov_offline}

    def by_path(kernel):
        return {name: r["launches"][kernel] for name, r in paths.items()}

    emit({"kernels": [{
        "name": "msdeform_fwd",
        "route": "cuda",
        "source": "dvis_plus_tpu_torch/csrc/msdeform_fwd.cu",
        "replaces": "dvis_plus_tpu/ops/msdeform_pallas.py:67",
        "launches": runs["exact"]["launches"]["msdeform_fwd"],
        "launches_by_path": by_path("msdeform_fwd"),
        "max_abs_err": max(f["max_abs_err"] for forms in b1.values() for f in forms),
        "ms": b1_main["ms"],
        "plain_ms": b1_main["plain_ms"],
        "bound_ms": b1_main["bound_ms"],
        "bound_by": b1_main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes it
        "by_shape": {name: {k: f[k] for k in b1_keys} for name, f in b1_shapes.items()},
    }, {
        "name": "swin_window_attn_fwd",
        "route": "cuda",
        "source": "dvis_plus_tpu_torch/csrc/swin_window_attn_fwd.cu",
        "replaces": "dvis_plus_tpu/ops/swin_window_attn.py:60",
        "launches": swinl["launches"]["swin_window_attn_fwd"],
        "launches_by_path": by_path("swin_window_attn_fwd"),
        "max_abs_err": max(f["max_abs_err"] for f in b2),
        "ms": b2_main["ms"],
        "plain_ms": b2_main["plain_ms"],
        "bound_ms": b2_main["bound_ms"],
        "bound_by": b2_main["bound_by"],
        "library_ms": b2_main["library_ms"],
        "by_shape": {name: {**{k: f[k] for k in timing_keys + ("library_ms",)},
                            "launches": b2_counted[f["B_"], f["heads"], bool(f["nW"])]}
                     for name, f in b2_shapes.items()},
    }, {
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "dvis_plus_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "dvis_plus_tpu/ops/flash_attn.py:41",
        "launches": vitl["launches"]["flash_attn_fwd"],
        "launches_by_path": by_path("flash_attn_fwd"),
        "max_abs_err": max(f["max_abs_err"] for f in b3),
        "ms": b3_main["ms"],
        "plain_ms": b3_main["plain_ms"],
        "bound_ms": b3_main["bound_ms"],
        "bound_by": b3_main["bound_by"],
        "library_ms": b3_main["library_ms"],
        "by_shape": {name: {k: f[k] for k in timing_keys + ("library_ms",)}
                     for name, f in b3_shapes.items()},
    }]})
    emit({"phase": "wall", "seconds": time.perf_counter() - start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
