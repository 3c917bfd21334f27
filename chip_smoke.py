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
  beside them in the GPU-against-CPU phase;
- DVIS++ online training at the full width of
  ``configs/dvis/dvis_online_r50_ytvis19.yaml`` (kernel B1 forward in the
  frozen segmenter, 6 launches a step): 8 clips of 5 frames at 480x768 from
  a synthetic set through the port's loader, train step and checkpoint; one
  small step GPU against CPU first, then 60 steps of a tiny model whose
  loss must fall;
- stages 1 and 3 of the DVIS++ recipe: B1's backward kernels against
  autograd of their twin (``b1_backward``: uniform, initialisation's and
  ``far`` offsets, each line with its time by kernel and the share of
  samples no value-gradient window holds), one small MinVIS and one CTVIS
  step GPU against CPU, then MinVIS, CTVIS (the whole segmenter trained:
  B1 forward and backward, 6 launches each a step) and DVIS++ offline (the
  refiner on the frozen online model: B1 forward only) at the full width of
  ``configs/dvis/{minvis,ctvis,dvis_offline}_r50_ytvis19.yaml``, 8 clips of
  5 (offline: 15) frames at 480x768 through the port's loader, and 100
  steps of a tiny MinVIS whose loss must fall;
- the segmenters trained with other backbones and on COCO pseudo-videos:
  B1's backward at the ViT-L extractor's training shape, small MinVIS
  steps with a ViT-Adapter and with a Swin, a small Mask2Former and Video
  Mask2Former step, each GPU against CPU, then MinVIS and CTVIS at the full
  width of ``configs/dvis/{minvis,ctvis}_vitl_ytvis19.yaml`` (the DINOv2
  trunk frozen; B1 forward and backward in the 6 encoder layers and the 6
  extractors, 12 each a step), Mask2Former and Video Mask2Former at the
  full width of ``configs/dvis/maskformer_r50_coco.yaml`` and
  ``video_maskformer_r50_coco_joint.yaml`` on synthetic COCO images made
  pseudo-videos (one step with large-scale jitter), and 60 steps of a
  tiny Mask2Former whose loss must fall;
- DVIS-DAQ training and the segmenter trained on VIPSeg and VSPW: small
  DAQ steps (online in stages 2 and 3, offline) and a MinVIS step on a
  VIPSeg batch, each GPU against CPU, then DVIS-DAQ online at the full
  width of ``configs/daq/daq_online_vitl_ytvis19.yaml`` and
  ``daq_online_vitl_vipseg.yaml`` (the cutter on the frozen ViT-L
  segmenter: B1 forward only, 12 launches a step, stage 2 then 3, the
  frame-count curriculum's two lengths) and offline at
  ``daq_offline_vitl_ytvis19.yaml`` (the refiner on the frozen segmenter
  and cutter, 10 of its 15 sampled frames), MinVIS at ``configs/dvis/minvis_r50_{vipseg,vspw}.yaml``
  (B1 forward and backward, 6 each a step), all from synthetic 720x1280
  frames through the port's loader and panoptic or semantic training
  mapper, B1's forward at the DAQ ViT-L step's shapes, and 60 steps of a
  tiny DVIS-DAQ whose loss must fall;
- open-vocabulary training: small steps of the FC-CLIP segmenter
  (MinVIS OV), OV-DVIS++ online and offline, and of the FC-CLIP segmenter
  at the full width of ``configs/ov/fcclip_r50_coco.yaml`` (the CLIP RN50
  trunk), each GPU against CPU; then, with the CLIP ConvNeXt-L trunk frozen
  and random text classifiers, the FC-CLIP segmenter at the full width of
  ``configs/ov/fcclip_convnextl_coco.yaml`` (B1 forward and backward, 6
  each a step, checked at the encoder's shape), OV-DVIS++ online and
  offline at ``ov_{online,offline}_convnextl_coco.yaml`` (B1 forward only)
  on synthetic COCO panoptic pseudo-videos, and the supervised mixture of
  ``ov_online_convnextl_supervised.yaml`` on five synthetic sets, each
  batch against its set's classifier;
- the demo and the last modules: ``python -m dvis_plus_tpu_torch.demo`` at the
  full width of ``configs/dvis/dvis_online_r50_ytvis19.yaml`` on 30
  synthetic 720x1280 JPEG frames, whole-video and ``--chunk-size 10`` (B1
  6 launches a window), its fp32 overlays on the card against the CPU's
  (``demo_slice``); the FPN pixel decoder on the same YAML, eval (no B1
  launch) and a small training step card against CPU (``fpn_slice``,
  ``fpn_train_step_parity``); ``backbone.swin_fast_softmax`` on the Swin-L
  offline model, one eval window through B2 and B2 held against the
  bf16-score plain path on that window's inputs (``swin_fast_softmax``);
- multi-device training and eval on the one card: DVIS++ online training
  at the full width of ``configs/dvis/dvis_online_r50_ytvis19.yaml``
  through the CLI's loop under a process group of one NCCL rank against
  the same run in one process (``ddp_train_slice``: B1 forward, 6 launches
  a step); two gloo ranks spawned on the card, a step of 4 + 4 clips
  against one process's step of 8 (``ddp2_train_step_parity``), then the
  CLI's eval with each rank its stripe of the videos, rank 0 writing the
  rows rank by rank (``dist_eval_slice``); the eval fanned out over two
  worker threads on the card (``parallel_eval_slice``: ``results.json``
  equal to the sequential run's bytes); and the offline refiner's
  object-sharded pass over the card named twice against the plain pass
  (``refiner_sharded_parity``). A run over more than one card needs a
  machine with more.

Run from a checkout of the repository:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # build, then only the kernels against their
                                     # plain versions and the wrappers' host time
    python3 chip_smoke.py --profile [vitl] [swinl] [r50] [daq] [ov]
                                     # build, then stage times and a torch.profiler
                                     # breakdown of one video of each slice named
    python3 chip_smoke.py --b1-runs  # build, then kernel B1's time at its main shapes
                                     # by the run of queries a block takes
    python3 chip_smoke.py --b1-backward  # build, then only B1's backward against
                                         # autograd of its twin, timed
    python3 chip_smoke.py --daq      # build, then only the DVIS-DAQ phases
    python3 chip_smoke.py --ov       # build, then only the open-vocabulary phases
    python3 chip_smoke.py --train    # build, then only the training phases (B1's
                                     # backward among them)
    python3 chip_smoke.py --train-segmenters  # build, then B1's backward and the
                                              # ViT-L, Swin and COCO training phases
    python3 chip_smoke.py --train-daq  # build, then the DVIS-DAQ, VPS and VSS
                                       # training phases
    python3 chip_smoke.py --train-ov   # build, then the open-vocabulary training
                                       # phases
    python3 chip_smoke.py --parallel   # build, then the multi-device phases
    python3 chip_smoke.py --demo       # build, then the demo, FPN decoder and Swin
                                       # bf16-score phases

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


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets ``at_s``, the script's
    seconds so far, so that a run's lines give each phase's time."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _START, 1)}
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
    +-``spread``, ``far`` uniform over +-FAR_SPREAD, or ``init``: the
    initialisation's plus N(0, 0.25) noise."""
    import torch

    if offsets in ("uniform", "far"):
        spread = FAR_SPREAD if offsets == "far" else spread
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


def extractor_grids(grid=VIT_GRID):
    Hv, Wv = grid
    return [(2 * Hv, 2 * Wv), (Hv, Wv), (Hv // 2, Wv // 2)]


def extractor_inputs(dev, seed=SEED, BT=5, M=16, D=64, P=4, offsets="uniform", grid=VIT_GRID):
    """B1 as the ViT-L adapter's extractors call it: the three spatial grids
    (at the serving size 92x160, 46x80, 23x40 = 19,320 queries a frame;
    ``grid`` (30, 48), the 480x768 training canvas: 7,560) attend into the
    one ViT level ``grid``, 16 heads of 64 channels. ``uniform`` offsets
    reach 6 pixels."""
    import torch

    from dvis_plus_tpu_torch.models.segmenter.pixel_decoder import reference_points

    g = torch.Generator(device="cpu").manual_seed(seed)
    Hv, Wv = grid
    ref = reference_points(extractor_grids(grid))[:, 1:2][None, :, None, :, None, :]  # (1, Lq, 1, 1, 1, 2)
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

    return {"msdeform_fwd": msdeform.launches, "msdeform_bwd": msdeform.backward_launches,
            "swin_window_attn_fwd": swin_window_attn.launches, "flash_attn_fwd": flash_attn.launches}


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
              "msdeform_bwd": 0, "swin_window_attn_fwd": 0, "flash_attn_fwd": 0}
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
              "msdeform_bwd": 0, "swin_window_attn_fwd": sum(cfg.model.backbone.swin_depths) * windows,
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
              "msdeform_bwd": 0, "swin_window_attn_fwd": 0, "flash_attn_fwd": b.vit_depth * windows}

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
            "msdeform_bwd": 0, "swin_window_attn_fwd": 0, "flash_attn_fwd": 0}


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

    # the clip decoder's heads resize (B, Q, T, h, w) masks frame by frame
    name = "_clip_heads" if hasattr(predictor, "_clip_heads") else "_prediction_heads"
    heads = getattr(predictor, name)
    stats = {"calls": 0, "differ": 0, "keys": 0, "margin": float("inf")}

    def call(output, mask_features, attn_size):
        x, masks, additive = heads(output, mask_features, attn_size)
        am = F.interpolate(masks.flatten(1, 2) if masks.dim() == 5 else masks, size=attn_size,
                           mode="bilinear", align_corners=False)
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

    setattr(predictor, name, call)
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
    over the same video: the time by kernel and by operator."""
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


# DVIS++ online training: the main configuration's clips (ims_per_batch 8 x
# sampling_frame_num 5 on the 480x768 canvas), 2 untimed and 5 timed steps;
# the GPU-against-CPU step at small widths holds the losses to 1e-4 and the
# tracker's gradients to 1e-3 as a norm (fp32, TF32 off)
TRAIN_H, TRAIN_W, TRAIN_UNTIMED, TRAIN_TIMED = 480, 768, 2, 3
STAGE_UNTIMED, STAGE_TIMED = 1, 2  # the MinVIS, CTVIS and DVIS++ offline slices
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
TRAIN_LEVELS = [(60, 96), (30, 48), (15, 24)]  # the 480x768 canvas: strides 8, 16, 32
FIT_SHARE = 0.95  # the share of the card's memory a training slice's peak may take
VIT_TRAIN_GRID = (30, 48)  # the ViT-L trunk's tokens on the 480x768 canvas


def write_ytvis(root, name, n_videos, length, H, W, classes=None):
    """``dvis_plus_tpu_torch/tools/synth_data.py::make_ytvis`` (JPEG frames,
    a moving box for two instances a video, the second leaving half-way);
    registered in the port's catalog as ``<name>_train``, with its class
    names (an open-vocabulary classifier's vocabulary where no file has
    one)."""
    from dvis_plus_tpu_torch.data.catalog import register_dataset
    from dvis_plus_tpu_torch.data.datasets.categories import YTVIS_2019_CLASSES
    from dvis_plus_tpu_torch.data.datasets.ytvis import load_ytvis_json
    from dvis_plus_tpu_torch.tools import synth_data

    classes = classes or YTVIS_2019_CLASSES
    synth_data.make_ytvis(root, name, classes, splits=("train",), n_videos=n_videos,
                          length=length, H=H, W=W)
    register_dataset(f"{name}_train", lambda: load_ytvis_json(
        os.path.join(root, name, "train.json"), os.path.join(root, name, "train", "JPEGImages")),
        thing_classes=list(classes))


@contextlib.contextmanager
def recording_matches(log):
    """Append every assignment the training loss makes to ``log``."""
    from dvis_plus_tpu_torch.losses import criterion

    match = criterion.match

    def recording(*args, **kw):
        q4g = match(*args, **kw)
        log.append(q4g.cpu())
        return q4g

    criterion.match = recording
    try:
        yield
    finally:
        criterion.match = match


def phase_train_step_parity(dev):
    """One DVIS++ online training step at small widths on the card against
    the CPU: the same seeded weights, batch (2 clips x 3 frames of 128x160)
    and draws (a CPU generator's values, moved to each device), fp32. The
    losses, the tracker's gradients and every assignment the loss made."""
    import copy

    import torch

    from dvis_plus_tpu_torch.config import tiny
    from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step
    from dvis_plus_tpu_torch.losses.targets import VideoTargets
    from dvis_plus_tpu_torch.models.meta.dvis_online import DVISOnline
    from dvis_plus_tpu_torch.utils.draws import Draws

    cfg = tiny("dvis_online", "model.num_classes=5", "model.tracker.matcher_solver=jv")
    B, T, N, H, W = 2, 3, 4, 128, 160
    g = torch.Generator().manual_seed(SEED)
    masks = torch.zeros(B, N, T, H, W, dtype=torch.bool)
    for b in range(B):
        for n in range(N - 1):
            y, x = 10 + 30 * n, 8 + 20 * b + 10 * n
            for t in range(T):
                if not (n == 1 and t == 0):
                    masks[b, n, t, y:y + 28, x + 4 * t:x + 4 * t + 36] = True
    fv = masks.flatten(3).any(-1)
    batch = Batch(torch.randn(B, T, 3, H, W, generator=g),
                  VideoTargets(torch.randint(0, 5, (B, N), generator=g), masks, fv.any(-1), fv))
    torch.manual_seed(SEED)
    cpu_model = DVISOnline(cfg.model).train()
    out = []
    for d, model in ((torch.device("cpu"), cpu_model), (dev, copy.deepcopy(cpu_model).to(dev))):
        b = Batch(batch.images.to(d), VideoTargets(*(t.to(d) for t in batch.targets)))
        step, init = build_train_step(cfg, model)
        matches = []
        with recording_matches(matches):
            _, metrics = step(init(), b, Draws(torch.Generator().manual_seed(SEED + 7)))
        grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters() if p.requires_grad}
        out.append(({k: float(v) for k, v in metrics.items()}, grads, matches))
    (want, gw, mw), (got, gg, mg) = out
    loss_err = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want}
    flat_w = torch.cat([v.flatten() for v in gw.values()])
    flat_g = torch.cat([gg[k].flatten() for k in gw])
    grad_err = ((flat_g - flat_w).norm() / flat_w.norm()).item()
    norm_err = abs(flat_g.norm().item() - flat_w.norm().item()) / flat_w.norm().item()
    same = len(mw) == len(mg) and all(torch.equal(a, b) for a, b in zip(mw, mg))
    finite = all(np.isfinite(v) for v in got.values())
    emit({"phase": "train_step_parity", "clips": B, "frames": T, "input": [H, W],
          "loss_rel_err": max(loss_err.values()), "loss_tol": TRAIN_LOSS_TOL,
          "grad_rel_err": grad_err, "grad_norm_rel_err": norm_err, "grad_tol": TRAIN_GRAD_TOL,
          "total_loss": {"cpu": want["total_loss"], "cuda": got["total_loss"]},
          "assignments": [m.tolist() for m in mg], "assignments_equal": same})
    if not (finite and same and max(loss_err.values()) <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL):
        raise AssertionError(f"the training step on the card disagrees with the CPU: losses "
                             f"{loss_err}, gradients {grad_err}, assignments equal {same}")


@contextlib.contextmanager
def marking(targets, at):
    """Wrap each ``(obj, attr, start, end)``: record in ``at`` the host clock
    (after a synchronize) under ``start`` before the call and, when ``end``
    is given, under ``end`` after it."""
    import torch

    def marked(fn, start, end):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            at[start] = time.perf_counter()
            out = fn(*args, **kw)
            if end:
                torch.cuda.synchronize()
                at[end] = time.perf_counter()
            return out
        return wrapped

    for obj, attr, start, end in targets:
        setattr(obj, attr, marked(getattr(obj, attr), start, end))
    try:
        yield at
    finally:
        for obj, attr, _, _ in targets:
            delattr(obj, attr)


def stage_marks(arch, model, optimizer):
    """The stage boundaries of a training step of ``arch``: (targets for
    :func:`marking`, stages as (name, start mark, end mark)). Every step
    ends in the loss (from the forward's end to the optimizer's
    ``zero_grad``), the backward (to its ``step``) and the optimizer."""
    opt = [(optimizer, "zero_grad", "loss_end", None), (optimizer, "step", "backward_end", "end")]
    tail = [("loss", "forward_end", "loss_end"), ("backward", "loss_end", "backward_end"),
            ("optimizer", "backward_end", "end")]
    if arch in ("dvis_online", "dvis_online_ov"):
        return ([(model, "train_forward", "forward", "forward_end"),
                 (model.tracker, "forward", "tracker", "tracker_end")] + opt,
                [("segmenter_forward", "forward", "tracker"),
                 ("tracker_forward", "tracker", "tracker_end")] + tail)
    if arch == "dvis_offline_ov":
        return ([(model, "train_forward", "online", "forward_end"),
                 (model.refiner, "forward", "refiner", None)] + opt,
                [("online_forward", "online", "refiner"), ("refiner_forward", "refiner", "forward_end")]
                + tail)
    if arch.startswith("daq_"):
        return ([(model, "train_forward", "forward", "forward_end")] + opt,
                [("forward", "forward", "forward_end")] + tail)
    if arch == "dvis_offline":
        return ([(model, "_online", "online", "online_end"),
                 (model.refiner, "forward", "refiner", "forward_end")] + opt,
                [("online_forward", "online", "online_end"), ("refiner_forward", "refiner", "forward_end")]
                + tail)
    return ([(model, "forward", "segmenter", "forward_end")] + opt,
            [("segmenter_forward", "segmenter", "forward_end")] + tail)


@contextlib.contextmanager
def wrapping(targets):
    """Inside the block, each ``(obj, attr, wrap)``'s attribute is
    ``wrap(the attribute)``; after it, what it was."""
    saved = [(obj, attr, vars(obj).get(attr), attr in vars(obj)) for obj, attr, _ in targets]
    for obj, attr, wrap in targets:
        setattr(obj, attr, wrap(getattr(obj, attr)))
    try:
        yield
    finally:
        for obj, attr, old, had in reversed(saved):
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)


@contextlib.contextmanager
def timing_stages(arch, model, optimizer, ms):
    """Time the stages of the real training step of ``arch``
    (``engine/trainer.py::build_train_step``) run inside the block, on the
    host clock with a synchronize at every boundary (:func:`stage_marks`),
    and inside them the loss matchers' host solves and the tracker's frame
    alignments (each waited for; one a frame, its clips solved together);
    with the ViT-Adapter its trunk's forward, and in DVIS-DAQ each clip's
    frozen segmenter, the frame matchings, and online the cutter with its
    new-instance matchings and slot auctions, offline the frozen stream
    and the refiner (each synchronized). Fills ``ms`` with milliseconds by
    stage and part, the whole step, and the calls of each part."""
    import torch

    from dvis_plus_tpu_torch.losses import criterion
    from dvis_plus_tpu_torch.models.daq import cutter as cutter_mod
    from dvis_plus_tpu_torch.models.meta import daq as daq_mod
    from dvis_plus_tpu_torch.models.tracker import referring_tracker

    at, acc = {}, {}

    def timed(key, wait=False, sync=False):
        def wrap(fn):
            def wrapped(*args, **kw):
                if sync:
                    torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args, **kw)
                if wait:
                    out.cpu()
                if sync:
                    torch.cuda.synchronize()
                a = acc.setdefault(key, [0.0, 0])
                a[0] += 1e3 * (time.perf_counter() - t)
                a[1] += 1
                return out
            return wrapped
        return wrap

    # every module of the port that holds the loss matcher by name
    holders = [m for n, m in list(sys.modules.items())
               if n.startswith("dvis_plus_tpu_torch.") and getattr(m, "match", None) is criterion.match]
    match = timed("loss_matchers")(criterion.match)
    targets = [(m, "match", lambda _: match) for m in holders]
    targets.append((referring_tracker, "match_embds", timed("tracker_alignments", wait=True)))
    # the ViT-Adapter's trunk (patch embedding and blocks), apart from the adapter
    vit = getattr(getattr(model, "backbone", None), "vit_module", None)
    if vit is not None:
        targets += [(vit, n, timed("vit_trunk_forward", sync=True)) for n in ("prepare_tokens", "run_blocks")]
    if arch.startswith("daq_"):
        tracker = model.tracker
        parts = [(daq_mod, "frame_match", "frame_matches"), (cutter_mod, "new_ins_match", "new_ins_matches"),
                 (model, "_segment_clip", "segmenter"), (tracker, "_match_slots_to_seg", "slot_auctions")]
        parts += ([(tracker, "inference_step", "stream"), (model.refiner, "forward", "refiner")]
                  if arch == "daq_offline" else [(tracker, "forward", "cutter")])
        targets += [(obj, attr, timed(key, sync=True)) for obj, attr, key in parts]
    marks, spans = stage_marks(arch, model, optimizer)
    with wrapping(targets), marking(marks, at):
        yield ms
    ms.update({name: 1e3 * (at[end] - at[start]) for name, start, end in spans})
    for key in ("tracker_alignments", "loss_matchers"):
        acc.setdefault(key, [0.0, 0])
    for key, (total, calls) in acc.items():
        ms[key] = total
        ms[f"{key}_calls"] = calls
    if vit is not None:
        # DVIS-DAQ times its segmenter as a part, a clip at a time
        seg = ms["segmenter" if arch.startswith("daq_") else "segmenter_forward"]
        ms["adapter_and_heads_forward"] = seg - ms["vit_trunk_forward"]
    ms["step"] = 1e3 * (at["end"] - at[spans[0][1]])


@contextlib.contextmanager
def recording_b1(calls):
    """Record every call of B1 in the pixel decoder inside the block:
    (value shape, value dtype, weights dtype, level shapes)."""
    from dvis_plus_tpu_torch.models.segmenter import pixel_decoder

    plain = pixel_decoder.ms_deform_attn

    def recording(value, shapes, loc, attn, radius=None):
        calls.append((tuple(value.shape), str(value.dtype).split(".")[1],
                      str(attn.dtype).split(".")[1], [list(s) for s in shapes]))
        return plain(value, shapes, loc, attn, radius=radius)

    pixel_decoder.ms_deform_attn = recording
    try:
        yield calls
    finally:
        pixel_decoder.ms_deform_attn = plain


def b1_per_step(cfg):
    """B1 launches a training step of ``cfg``: one an encoder layer (none
    with the FPN pixel decoder), and with the ViT-Adapter one an extractor
    (one an interaction, and the last interaction's two extra)."""
    n = 0 if cfg.model.pixel_decoder.name == "fpn" else cfg.model.pixel_decoder.transformer_enc_layers
    if cfg.model.backbone.name == "vit_adapter_dinov2":
        n += len(cfg.model.backbone.vit_interaction_indexes) + 2
    return n


def write_coco(root, n_images, H, W):
    """``dvis_plus_tpu_torch/tools/synth_data.py::make_coco`` (JPEG images,
    two moving boxes an image, COCO's person and bicycle); every COCO split
    registered in the port's catalog (``coco2ytvis2019_train`` among
    them)."""
    from dvis_plus_tpu_torch.data.datasets.coco import register_all_coco
    from dvis_plus_tpu_torch.tools import synth_data

    synth_data.make_coco(root, n_images=n_images, H=H, W=W)
    register_all_coco(root)


def total_memory(dev) -> int:
    import torch

    return torch.cuda.get_device_properties(dev).total_memory


def train_canvas(cfg):
    """The training mapper's static canvas: the largest training size,
    each side rounded up to the size divisibility."""
    div = cfg.model.size_divisibility
    return [-(-max(cfg.input.min_size_train) // div) * div, -(-cfg.input.max_size_train // div) * div]


def phase_train_slice(dev, arch="dvis_online", phase="train_slice", untimed=TRAIN_UNTIMED,
                      timed=TRAIN_TIMED, preset=None, lsj=False, data=None, frame=(TRAIN_H, TRAIN_W),
                      b1_shape=False, loader_seed=SEED, count_syncs=True):
    """Training of ``arch`` at the full width of its preset (``preset``, or
    ``config.TRAIN_PRESETS[arch]``: ``configs/dvis/{arch}_r50_ytvis19.yaml``,
    ``maskformer_r50_coco.yaml``, ``video_maskformer_r50_coco_joint.yaml``;
    bf16 compute, fp32 parameters and moments, 8 clips on the 480x768
    canvas of 5 frames, or of 15 (``sampling_frame_num``) for the offline
    stage, 1 or 2 for the COCO pseudo-videos; 12,544 points) with seeded
    random weights (DVIS-DAQ's cutter's class head as
    :data:`DAQ_TRAIN_HEADS`), on a synthetic set written to a temporary
    directory (YouTube-VIS frames of ``frame``, or COCO images of 480x640
    that the pseudo-video mapper rotates and resizes), through the port's
    loader (4 worker threads) and the CLI's frame-count curriculum (a no-op
    but for DVIS-DAQ online): ``untimed`` steps, then ``timed`` ones, then
    one step timed by stage (:func:`timing_stages`) and one whose host
    syncs are counted. MinVIS, CTVIS and the Mask2Formers train the whole
    segmenter (a ViT-Adapter's trunk frozen), DVIS++ online the tracker on
    it frozen, DVIS++ offline the refiner on the frozen online model with
    its class memory, DVIS-DAQ online the cutter and offline the refiner,
    the segmenter running a clip at a time. The losses of every step must
    be finite, B1's forward launch :func:`b1_per_step` times a step (a clip
    in DVIS-DAQ), and its backward as often where the segmenter trains,
    never where it is frozen. If 8 clips do not fit the card, the largest
    count that does (halving; a count whose peak passes :data:`FIT_SHARE`
    of the card's memory counts as not fitting) and its peak are reported.
    B1's encoder calls are recorded by shape; with ``b1_shape`` B1 is
    checked and timed at the largest of them, exact and clamped (r7), and
    where the segmenter trains so is its backward. DVIS++ online also times
    a checkpoint save; with ``lsj`` one more step takes its batch with
    ``input.lsj_aug`` on (the configuration's own LSJ size), and B1's
    backward is timed at the encoder shape that step gave it. ``data``
    (root, clips) -> dataset name writes another synthetic set instead (the
    canvas then follows the configuration), or, returning None, the sets of
    the configuration's ``datasets.train``. An open-vocabulary
    configuration trains :func:`ov_model` against one random text
    classifier a training set (:func:`ov_train_classifiers`), the CLIP
    trunk frozen; the FC-CLIP segmenter (``minvis_ov``) also trains its
    decoders, so B1's backward runs there, and the schedule gives each
    step's training set. ``loader_seed`` seeds the loader (a mixture's
    order of sets). Without ``count_syncs`` the step whose syncs are
    counted is left out (a slow step taken once)."""
    import gc

    import torch

    from dvis_plus_tpu_torch.config import TRAIN_PRESETS, is_ov
    from dvis_plus_tpu_torch.core import checkpoint as ckpt
    from dvis_plus_tpu_torch.data.build import build_combined_train_loader
    from dvis_plus_tpu_torch.engine import trainer

    online, daq = arch == "dvis_online", arch.startswith("daq_")
    preset = preset or TRAIN_PRESETS[arch]
    steps, tried, b1_calls = untimed + timed + 1 + count_syncs, [], []
    with tempfile.TemporaryDirectory() as root:
        cfg = preset()
        coco = bool({"image_instance", "image_panoptic"} & set(cfg.datasets.dataset_type))
        if data is not None:
            train_set = data(root, cfg.solver.ims_per_batch)
        elif coco:
            write_coco(root, n_images=cfg.solver.ims_per_batch, H=480, W=640)
        else:
            write_ytvis(root, f"ytvis_{phase}", n_videos=cfg.solver.ims_per_batch,
                        length=max(10, cfg.input.sampling_frame_num + 2), H=frame[0], W=frame[1])
        clips = cfg.solver.ims_per_batch
        while True:
            cfg = preset()
            if data is not None:
                if train_set:
                    cfg.datasets.train = (train_set,)
            elif not coco:
                cfg.datasets.train = (f"ytvis_{phase}_train",)
            cfg.solver.ims_per_batch = clips
            tried.append(clips)
            if is_ov(cfg):
                model = ov_model(cfg, dev).train()
                classifiers = ov_train_classifiers(cfg, dev)
            else:
                model = (daq_model(cfg, dev, DAQ_TRAIN_HEADS) if daq else build_model(cfg, dev)).train()
                classifiers = ()
            train_step, init = trainer.build_train_step(cfg, model, classifiers)
            # B1's backward runs where the pixel decoder trains
            trains_segmenter = any(p.requires_grad for n, p in model.named_parameters()
                                   if n.startswith("sem_seg_head.pixel_decoder."))
            state = init()
            loader = build_combined_train_loader(cfg, seed=loader_seed)
            curriculum = trainer.curriculum_rng(cfg)
            losses, wait_s, step_s, schedule, batch, stages, counts = [], [], [], [], None, {}, []

            def next_batch():
                raw = trainer.daq_curriculum_slice(cfg, state.step, next(loader), curriculum)
                out = trainer.to_batch(raw, dev)
                schedule.append([out.images.shape[1],
                                 trainer.daq_stage(cfg, state.step) if arch == "daq_online" else None,
                                 out.dataset_index])
                return out

            def step(batch):
                nonlocal state
                state, metrics = train_step(state, batch)
                losses.append({k: float(v) for k, v in metrics.items()})  # synchronizes

            b1_calls.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            try:
                with recording_b1(b1_calls):
                    reset_launches()
                    for i in range(untimed + timed):
                        t0 = time.perf_counter()
                        batch = next_batch()
                        t1 = time.perf_counter()
                        step(batch)
                        if i >= untimed:
                            wait_s.append(t1 - t0)
                            step_s.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    batch = next_batch()
                    staged_wait = time.perf_counter() - t0
                    with timing_stages(arch, model, state.optimizer, stages):
                        step(batch)
                    if count_syncs:
                        schedule.append(schedule[-1][:1] + [
                            trainer.daq_stage(cfg, state.step) if arch == "daq_online" else None,
                            batch.dataset_index])
                        # the step's own syncs: its losses are read after the count
                        with counting_syncs(counts):
                            state, metrics = train_step(state, batch)
                            torch.cuda.synchronize()
                        losses.append({k: float(v) for k, v in metrics.items()})
                    launches = read_launches()
                # a count that leaves the card under 5 % free does not fit:
                # the phase's later steps would risk running out
                if clips == 1 or torch.cuda.max_memory_allocated(dev) <= FIT_SHARE * total_memory(dev):
                    break
            except torch.cuda.OutOfMemoryError:
                if clips == 1:
                    raise
            # outside the handler, so that its traceback's frames are gone
            del model, state, train_step, loader, batch
            gc.collect()
            torch.cuda.empty_cache()
            clips //= 2
        peak = torch.cuda.max_memory_allocated(dev)
        extra = {}
        if online:
            t0 = time.perf_counter()
            ckpt.save(os.path.join(root, "checkpoints", f"step_{state.step:07d}.pth"), model,
                      state.optimizer.state_dict(), state.step, torch.get_rng_state())
            extra["checkpoint_save_s"] = time.perf_counter() - t0
        if lsj:
            extra["lsj_step"] = lsj_step(dev, cfg, model, state, train_step)
        memory = None if state.memory is None else int(state.memory.count.sum())
        del model, state, train_step, loader, batch
    gc.collect()
    torch.cuda.empty_cache()
    finite = all(np.isfinite(v) for row in losses for v in row.values())
    per_step = {"msdeform_fwd": launches["msdeform_fwd"] / steps,
                "msdeform_bwd": launches["msdeform_bwd"] / steps}
    n = b1_per_step(cfg) * (clips if daq else 1)
    want = {"msdeform_fwd": n, "msdeform_bwd": n if trains_segmenter else 0}
    res = {"phase": phase, "arch": arch, "backbone": cfg.model.backbone.name, "clips": clips,
           "clips_tried": tried, "frames": cfg.input.sampling_frame_num, "canvas": train_canvas(cfg),
           "dtype": cfg.model.compute_dtype, "steps": steps, "timed_steps": timed,
           "schedule_frames_stage_set": schedule,
           "total_loss": [row["total_loss"] for row in losses], "losses_last": losses[-1],
           "finite": finite, "step_s_median": float(np.median(step_s)) if step_s else None,
           "step_s": step_s, "loader_wait_s": wait_s, "staged_step_loader_wait_s": staged_wait,
           "peak_memory_bytes": peak,
           "host_syncs_per_step": {"event_waits": counts[0], "debug_mode": counts[1]} if counts else None,
           "stages_ms": stages, "launches": launches, "b1_launches_per_step": per_step,
           "class_memory_pushed": memory, **extra}
    shapes = sorted({(c[0], c[1], c[2], tuple(map(tuple, c[3]))) for c in b1_calls})
    res["b1_calls"] = [{"value": list(v), "value_dtype": vd, "attn_dtype": ad, "levels": [list(x) for x in lv]}
                       for v, vd, ad, lv in shapes]
    lsj_ok = not lsj or extra["lsj_step"]["finite"]
    if not finite or per_step != want or (online and len(shapes) != 1) or not lsj_ok:
        emit({**res, "failed": True})
        raise AssertionError(f"{phase}: finite {finite}, B1 launches a step {per_step} (expected {want}), "
                             f"B1 shapes {shapes}, LSJ step finite {lsj_ok}")
    if b1_shape:
        # B1 at the largest encoder shape the step gave it, in its dtype
        (BT, _, M, D), value_dtype, _, levels = max(shapes)
        levels = [tuple(x) for x in levels]
        value, loc, attn = msdeform_inputs(dev, levels, BT=BT, M=M, D=D)
        value = value.to(getattr(torch, value_dtype))
        res["b1_train_encoder"] = b1_check(levels, value, loc, attn, iters=10, plain_iters=3)
        res["b1_train_encoder_r7"] = b1_check(levels, value, loc, attn, 7, iters=10, plain_iters=3)
        if trains_segmenter:
            res["b1_backward"] = [b1_backward_check(levels, value, loc, attn, radius) for radius in (None, 7)]
        del value, loc, attn
        torch.cuda.empty_cache()
    emit(res)
    return res


def lsj_step(dev, cfg, model, state, train_step):
    """One more training step whose batch the loader makes with
    ``input.lsj_aug`` on (a 0.1-2x scale of the ``max_size_train`` square,
    then that square cropped and fitted to the canvas): its time, losses,
    launches and B1's encoder calls; then B1's backward against autograd of
    its twin at the encoder shape that step gave it, timed."""
    import copy

    import torch

    from dvis_plus_tpu_torch.data.build import build_combined_train_loader
    from dvis_plus_tpu_torch.engine.trainer import to_batch

    cfg = copy.deepcopy(cfg)
    cfg.input.lsj_aug = True
    loader = build_combined_train_loader(cfg, seed=SEED + 1, num_workers=2)
    calls = []
    with recording_b1(calls):
        reset_launches()
        t0 = time.perf_counter()
        state, metrics = train_step(state, to_batch(next(loader), dev))
        losses = {k: float(v) for k, v in metrics.items()}
        step_s = time.perf_counter() - t0
        launches = read_launches()
    (value_shape, value_dtype, _, levels), = {(c[0], c[1], c[2], tuple(map(tuple, c[3]))) for c in calls}
    BT, _, M, D = value_shape
    value, loc, attn = msdeform_inputs(dev, list(levels), BT=BT, M=M, D=D)
    b1b = b1_backward_check(list(levels), value.to(getattr(torch, value_dtype)), loc, attn, iters=5,
                            plain_iters=1)
    del value, loc, attn
    return {"lsj_size": cfg.input.max_size_train, "step_s": step_s, "total_loss": losses["total_loss"],
            "finite": all(np.isfinite(v) for v in losses.values()), "launches": launches,
            "b1_value": list(value_shape), "b1_value_dtype": value_dtype, "b1_levels": list(levels),
            "b1_backward": {k: b1b[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "rel_err")}}


# the overfit phases' steps: every loss curve has fallen by about half by then
OVERFIT_STEPS = 60


def phase_train_overfit(dev, arch="dvis_online", phase="train_overfit", weights=None):
    """The port's slow overfit tests (``tests/test_torch_overfit.py`` runs
    this phase on the CPU): DVIS++ online (or ``arch``: ``minvis``,
    ``ctvis``, ``dvis_offline``; ``daq_online`` with the cutter of
    :data:`DAQ_TRAIN_TINY`; ``maskformer`` and ``video_maskformer`` on
    two synthetic COCO images as pseudo-videos of 1 and 2 frames;
    ``dvis_online_ov``, the OV tracker at :data:`OV_TRAIN_TINY` on its COCO
    YAML, against a random classifier of the set's two classes) at the
    tiny widths of ``config.TINY_TRAIN`` with 2 classes, 2 clips of 3 frames
    at 64x96 from a 2-video synthetic set, :data:`OVERFIT_STEPS` steps, from seeded weights or ``weights`` (a state dict: the
    earlier stage's model, loaded where the keys agree); the last total loss
    must be below the first, as the JAX slow test asserts. Returns the result
    with the trained model's state dict under ``state_dict``."""
    import torch

    from dvis_plus_tpu_torch.cli import build_model as build_arch
    from dvis_plus_tpu_torch.config import TINY_TRAIN, load_config, tiny
    from dvis_plus_tpu_torch.data.build import build_train_loader
    from dvis_plus_tpu_torch.data.datasets.categories import YTVIS_2019_CLASSES
    from dvis_plus_tpu_torch.data.mapper import mapper_for_type
    from dvis_plus_tpu_torch.engine.trainer import build_train_step, to_batch

    coco = arch in ("maskformer", "video_maskformer")
    overrides = ("model.num_classes=2", "solver.ims_per_batch=2", "solver.base_lr=3e-4",
                 "solver.warmup_iters=10", "solver.steps=[100000]", f"solver.max_iter={OVERFIT_STEPS}",
                 "input.min_size_train=[64]", "input.max_size_train=96")
    if not coco:
        overrides += ("input.sampling_frame_num=3", "input.sampling_frame_range=1")
    if arch.startswith("daq_"):
        overrides += DAQ_TRAIN_TINY
    ov = arch in OV_TRAIN_YAMLS
    if ov:
        cfg = load_config(OV_TRAIN_YAMLS[arch], [*TINY_TRAIN, *OV_TRAIN_TINY, *overrides,
                                                 "datasets.train=[ytvis_overfit_train]",
                                                 "datasets.dataset_type=[video_instance]"])
    else:
        cfg = tiny(arch, *overrides)
    with tempfile.TemporaryDirectory() as root:
        if coco:  # two 64x96 COCO images, their two categories (coco_2017_train)
            write_coco(root, n_images=2, H=64, W=96)
            dataset, mapper = "coco_2017_train", mapper_for_type(cfg, "image_instance", is_train=True)
        else:
            write_ytvis(root, "ytvis_overfit", n_videos=2, length=6, H=64, W=96,
                        classes=YTVIS_2019_CLASSES[:2])
            dataset, mapper = "ytvis_overfit_train", None
        torch.manual_seed(SEED + 1)
        model = ov_model(cfg, dev) if ov else build_arch(cfg.model)
        if weights is not None:
            model.load_state_dict(weights, strict=False)
        model = model.to(dev).train()
        step, init = build_train_step(cfg, model, ov_train_classifiers(cfg, dev) if ov else ())
        state = init()
        loader = build_train_loader(cfg, dataset, mapper, seed=SEED, num_workers=2)
        losses = []
        t0 = time.perf_counter()
        for k in range(cfg.solver.max_iter):
            state, metrics = step(state, to_batch(next(loader), dev))
            if k % 20 == 0 or k == cfg.solver.max_iter - 1:
                losses.append(float(metrics["total_loss"]))
        seconds = time.perf_counter() - t0
    res = {"phase": phase, "arch": arch, "steps": cfg.solver.max_iter, "total_loss": losses,
           "seconds": seconds}
    emit(res)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")
    return {**res, "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()}}


# ---------------------------------------------------------------------------
# Stages 1 and 3 of the DVIS++ recipe: MinVIS / CTVIS and DVIS++ offline
# training, and kernel B1's backward
# ---------------------------------------------------------------------------

# B1's backward: fp32 1e-5 of the twin's largest gradient (grad_value is
# summed with atomics, in another order); with bf16 values (and weights) the
# value and weight gradients are rounded once to bf16 on both sides
B1_GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the ``far`` offsets: uniform over +-64 value pixels, most of a level's
# width, so that neighbouring queries' samples scatter over the whole level
FAR_SPREAD = 64.0
# a training step GPU against CPU with the segmenter trained: the decoders'
# gradients as TRAIN_GRAD_TOL; the backbone's as a norm within 1e-2, since a
# ReLU input within rounding of 0 passes its gradient on one device and not
# on the other (tests/test_torch_minvis_train.py measures the JAX package
# against the port so: 1.6e-3)
TRAIN_BACKBONE_GRAD_TOL = 1e-2


def b1_backward_ops(value, levels, loc, radius):
    """The least operations of B1's backward on these inputs: per sample
    that reaches its level (counted on the data, after the clamp) and per
    channel, the four corners' dot products with the output's gradient g
    (4 multiply-adds), from which the weight's and both locations'
    gradients follow once a sample, and the four corners' value gradients
    (4 multiply-adds of g by a weight per corner): 16."""
    import torch

    from dvis_plus_tpu_torch.ops import msdeform

    if radius is not None:
        loc = msdeform.clamp_locations(loc, levels, radius)
    inside = 0
    for lid, (H, W) in enumerate(levels):
        x = torch.floor(loc[:, :, :, lid, :, 0] * W - 0.5)
        y = torch.floor(loc[:, :, :, lid, :, 1] * H - 0.5)
        inside += int(((x >= -1) & (x < W) & (y >= -1) & (y < H)).sum())
    return 16 * inside * value.shape[-1]


def b1_backward_direct_share(levels, value, loc, radius):
    """The share of samples with a corner in the level that no window of
    :func:`backward_plan` holds, so that it would have to be added to device
    memory directly. The kernel has no such route: its windows are bands of
    rows that tile every level. Counted on the data all the same (after the
    clamp), so that a plan whose bands left a row out would show here."""
    import torch

    from dvis_plus_tpu_torch.ops import msdeform

    plan = msdeform.backward_plan(value, loc, levels)
    if radius is not None:
        loc = msdeform.clamp_locations(loc, levels, radius)
    outside = reached = 0
    for lid, (H, W) in enumerate(levels):
        x = torch.floor(loc[:, :, :, lid, :, 0] * W - 0.5)
        y = torch.floor(loc[:, :, :, lid, :, 1] * H - 0.5)
        inside = (x >= -1) & (x < W) & (y >= -1) & (y < H)
        covered = torch.zeros(H + 1, dtype=torch.bool, device=loc.device)
        for r0 in range(0, H, plan.rows[lid]):
            covered[r0:min(r0 + plan.rows[lid], H)] = True
        rows_ok = covered[y.clamp(0, H).long()] | (y < 0)
        rows_ok &= covered[(y + 1).clamp(0, H).long()] | (y + 1 >= H)
        outside += int((inside & ~rows_ok).sum())
        reached += int(inside.sum())
    return outside / max(reached, 1)


def b1_backward_by_kernel(call, calls=3):
    """Milliseconds a call of B1's backward spends in each of its kernels
    (the sample gradients; the sort and the value gradient, summed over the
    levels), from ``torch.profiler``'s device times over ``calls`` calls."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"msdeform_bwd_\w+?_kernel", e.key)
        if name:
            t = getattr(e, "self_device_time_total", 0)
            out[name.group(0)] = out.get(name.group(0), 0.0) + t / calls / 1e3
    return out


def b1_backward_check(levels, value, loc, attn, radius=None, iters=5, plain_iters=3):
    """B1's backward kernel against autograd of the twin on these inputs (one
    output gradient for both), each gradient's error, then both timed: the
    kernel alone (``_launch_backward``), the twin's backward alone (its graph
    kept), with the bound: every input and output moved once (value,
    locations, weights and the output's gradient read; the three gradients
    written) over 3.35 TB/s, or its operations over the fp32 peak."""
    import torch

    from dvis_plus_tpu_torch.ops import msdeform

    B, Lq = loc.shape[:2]
    g = torch.randn(B, Lq, value.shape[2] * value.shape[3],
                    generator=torch.Generator(device="cpu").manual_seed(SEED + 3)).to(value.device, value.dtype)

    def grads(fn):
        ins = [t.detach().clone().requires_grad_() for t in (value, loc, attn)]
        out = fn(ins[0], levels, ins[1], ins[2], radius=radius)
        return out, ins, torch.autograd.grad(out, ins, g, retain_graph=True)

    _, _, got = grads(msdeform.ms_deform_attn)
    torch.cuda.synchronize()
    out, ins, want = grads(msdeform.ms_deform_attn_torch)
    res = {"radius": radius, "value_dtype": str(value.dtype).split(".")[1],
           "attn_dtype": str(attn.dtype).split(".")[1], "max_abs_err": {}, "rel_err": {}, "tol": {}}
    ok = True
    for name, x, y, t in zip(("value", "locations", "weights"), got, want, (value, loc, attn)):
        err = (x.float() - y.float()).abs().max().item()
        rel = err / y.float().abs().max().item()
        tol = B1_GRAD_TOL[str(t.dtype).split(".")[1]]
        res["max_abs_err"][name], res["rel_err"][name], res["tol"][name] = err, rel, tol
        ok = ok and np.isfinite(rel) and rel <= tol
    if not ok:
        emit({"phase": "b1_backward", "failed": res})
        raise AssertionError(f"msdeform_bwd disagrees with autograd of its twin: {res}")
    del got, want
    res["ms"] = cuda_ms(lambda: msdeform._launch_backward(value, levels, loc, attn, radius, g),
                        iters, KERNEL_REPS)
    res["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(out, ins, g, retain_graph=True), plain_iters)
    grad_out = torch.empty(g.shape, device="meta", dtype=g.dtype)
    res["bound_ms"], res["bound_by"] = bound(
        (value, loc, attn, grad_out, torch.empty_like(value, device="meta"),
         torch.empty_like(loc, device="meta"), torch.empty_like(attn, device="meta")),
        b1_backward_ops(value, levels, loc, radius), torch.float32)
    res["library_ms"] = None  # no single PyTorch call computes it
    res["by_kernel_ms"] = b1_backward_by_kernel(lambda: msdeform._launch_backward(
        value, levels, loc, attn, radius, g))
    res["plan"] = msdeform.backward_plan(value, loc, levels)._asdict()
    res["direct_share"] = b1_backward_direct_share(levels, value, loc, radius)
    return res


def phase_b1_backward(dev):
    """B1's backward kernel (``csrc/msdeform_bwd.cu``) against autograd of
    the twin: small odd shapes first (both forms, fp32 and bf16, the
    extractor form), then the training encoder's shape (40, 7560, 8, 32)
    fp32, exact and clamped (r7), under uniform offsets and the
    initialisation's, and the ViT-L extractor's (5, 3680, 16, 64) with bf16
    values and weights; then the training encoder's shape, exact, under the
    ``far`` offsets (uniform over +-64 value pixels); then the ViT-L
    extractor's training shape (40, 1440, 16, 64) bf16, 7,560 queries, under
    both offset distributions. Each line gives the
    share of samples that no window of the value-gradient kernel holds
    (``direct_share``: 0 by design) and fails unless it is 0 for r7."""
    import torch

    n = 0
    for levels, B, M, D, P in B1_ODD_SHAPES:
        value, loc, attn = msdeform_inputs(dev, levels, SEED + 7, B, M, D, P)
        for dtype in (torch.float32, torch.bfloat16):
            for radius in (None, 2):
                b1_backward_check(levels, value.to(dtype), loc, attn.to(dtype), radius, iters=1,
                                  plain_iters=1)
                n += 1
    emit({"phase": "b1_backward", "odd_shapes": len(B1_ODD_SHAPES), "checks": n})
    forms = []
    for offsets in ("uniform", "init"):
        value, loc, attn = msdeform_inputs(dev, TRAIN_LEVELS, BT=40, offsets=offsets)
        for radius in (None, 7):
            forms.append({"shape": "train_encoder_480x768", "offsets": offsets,
                          **b1_backward_check(TRAIN_LEVELS, value, loc, attn, radius)})
            emit({"phase": "b1_backward", **forms[-1]})
        del value, loc, attn
        value, loc, attn = extractor_inputs(dev, offsets=offsets)
        forms.append({"shape": "vitl_extractor", "offsets": offsets, **b1_backward_check(
            [VIT_GRID], value.to(torch.bfloat16), loc, attn.to(torch.bfloat16))})
        emit({"phase": "b1_backward", **forms[-1]})
        del value, loc, attn
    value, loc, attn = msdeform_inputs(dev, TRAIN_LEVELS, BT=40, offsets="far")
    forms.append({"shape": "train_encoder_480x768", "offsets": "far",
                  **b1_backward_check(TRAIN_LEVELS, value, loc, attn)})
    emit({"phase": "b1_backward", **forms[-1]})
    del value, loc, attn
    # the ViT-L extractor in training: 8 clips x 5 frames on the 480x768
    # canvas, 1,440 ViT tokens (one 30x48 level) as the value, 7,560 queries
    for offsets in ("uniform", "init"):
        value, loc, attn = extractor_inputs(dev, BT=40, offsets=offsets, grid=VIT_TRAIN_GRID)
        forms.append({"shape": "vitl_extractor_train_480x768", "offsets": offsets, **b1_backward_check(
            [VIT_TRAIN_GRID], value.to(torch.bfloat16), loc, attn.to(torch.bfloat16))})
        emit({"phase": "b1_backward", **forms[-1]})
        del value, loc, attn
    torch.cuda.empty_cache()
    clamped = [f["direct_share"] for f in forms if f["radius"] is not None]
    if any(share != 0 for share in clamped):
        raise AssertionError(f"clamped samples outside every window of B1's backward: {clamped}")
    return forms


def off_grid(model, scale=0.25):
    """Move the deformable attention's sampling offsets off the pixel grid
    with seeded noise (in place). Their initialisation puts every sampling
    location exactly on a pixel corner, where the bilinear sample's
    derivative by the location jumps, so there the two devices' roundings
    pick the gradient of one side or the other (measured: the GPU's offset
    gradients 14-23 % from the CPU's, kernel and twin alike); a trained
    model's offsets lie anywhere."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(SEED + 11)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "sampling_offsets" in name:
                p.add_((torch.randn(p.shape, generator=g) * scale).to(p.device))


# the small step-parity phases' backbones: a 4-block ViT-Adapter of width 32
# (frozen trunk) and a Swin of width 32 with stochastic depth
VIT_TINY = ("model.backbone.name=vit_adapter_dinov2", "model.backbone.vit_embed_dim=32",
            "model.backbone.vit_depth=4", "model.backbone.vit_num_heads=2",
            "model.backbone.vit_deform_num_heads=2",
            "model.backbone.vit_interaction_indexes=[[0,0],[1,1],[2,2],[3,3]]",
            "model.backbone.vit_conv_inplane=8")
SWIN_TINY = ("model.backbone.name=swin_tiny", "model.backbone.swin_embed_dim=32",
             "model.backbone.swin_depths=[2,2,2,2]", "model.backbone.swin_num_heads=[1,2,4,8]",
             "model.backbone.swin_window_size=7")


def phase_stage_step_parity(dev, arch, phase=None, overrides=(), T=3, batch=None):
    """One training step of ``arch`` (MinVIS, CTVIS, Mask2Former on clips of
    one frame, Video Mask2Former) at small widths (``overrides``: another
    backbone) on the card against the CPU: the same seeded weights, batch
    (2 clips x ``T`` frames of 128x160) and draws, fp32, the whole
    segmenter trained (B1 forward and backward on the card; a ViT-Adapter's
    trunk frozen; Swin's window attention through the plain op, its drop
    path from the same coins), the card replaying the CPU's masked-attention
    decisions, the sampling offsets off the pixel grid (:func:`off_grid`).
    The losses, the decoders' and the backbone's gradients and every
    assignment the loss made. ``batch``: another batch (on the CPU) instead
    of the synthetic one."""
    import copy

    import torch

    from dvis_plus_tpu_torch.cli import build_model as build_arch
    from dvis_plus_tpu_torch.config import tiny
    from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step
    from dvis_plus_tpu_torch.losses.targets import VideoTargets
    from dvis_plus_tpu_torch.utils.draws import Draws

    cfg = tiny(arch, "model.num_classes=5", *overrides)
    if batch is None:
        B, N, H, W = 2, 4, 128, 160
        g = torch.Generator().manual_seed(SEED)
        masks = torch.zeros(B, N, T, H // 4, W // 4, dtype=torch.bool)
        for b in range(B):
            for n in range(N - 1):
                y, x = 3 + 8 * n, 2 + 5 * b + 3 * n
                for t in range(T):
                    if not (n == 1 and t == 0 and T > 1):
                        masks[b, n, t, y:y + 7, x + t:x + t + 9] = True
        fv = masks.flatten(3).any(-1)
        batch = Batch(torch.randn(B, T, 3, H, W, generator=g),
                      VideoTargets(torch.randint(0, 5, (B, N), generator=g), masks, fv.any(-1), fv))
    B, T, _, H, W = batch.images.shape
    torch.manual_seed(SEED)
    cpu_model = build_arch(cfg.model).train()
    off_grid(cpu_model)
    out, decisions, attention = [], [], {}
    reset_launches()
    for d, model in ((torch.device("cpu"), cpu_model), (dev, copy.deepcopy(cpu_model).to(dev))):
        b = Batch(batch.images.to(d), VideoTargets(*(t.to(d) for t in batch.targets)))
        # the card replays the CPU's masked-attention decisions: the random
        # model's mask logits lie near the threshold, where the two devices'
        # roundings decide otherwise (the line counts such keys)
        attention[d.type] = replay_attention(model.sem_seg_head.predictor, decisions,
                                             replay=d.type == "cuda")
        step, init = build_train_step(cfg, model)
        matches = []
        with recording_matches(matches):
            _, metrics = step(init(), b, Draws(torch.Generator().manual_seed(SEED + 7)))
        grads = {part: torch.cat([p.grad.detach().float().cpu().flatten()
                                  for n, p in model.named_parameters()
                                  if n.startswith(part) and p.grad is not None])
                 for part in ("sem_seg_head.", "backbone.")}
        out.append(({k: float(v) for k, v in metrics.items()}, grads, matches))
    launches = read_launches()
    (want, gw, mw), (got, gg, mg) = out
    loss_err = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want}
    grad_err = {part: ((gg[part] - gw[part]).norm() / gw[part].norm()).item() for part in gw}
    same = len(mw) == len(mg) and all(torch.equal(a, b) for a, b in zip(mw, mg))
    finite = all(np.isfinite(v) for v in got.values())
    n = b1_per_step(cfg)
    res = {"phase": phase or f"{arch}_train_step_parity", "backbone": cfg.model.backbone.name,
           "clips": B, "frames": T, "input": [H, W],
           "loss_rel_err": max(loss_err.values()), "loss_tol": TRAIN_LOSS_TOL,
           "grad_rel_err_norm": grad_err,
           "grad_tol": {"sem_seg_head.": TRAIN_GRAD_TOL, "backbone.": TRAIN_BACKBONE_GRAD_TOL},
           "total_loss": {"cpu": want["total_loss"], "cuda": got["total_loss"]},
           "assignments_equal": same, "launches": launches,
           "attention_keys_replayed": attention["cuda"]}
    emit(res)
    if not (finite and same and max(loss_err.values()) <= TRAIN_LOSS_TOL
            and grad_err["sem_seg_head."] <= TRAIN_GRAD_TOL
            and grad_err["backbone."] <= TRAIN_BACKBONE_GRAD_TOL
            and launches["msdeform_fwd"] == n and launches["msdeform_bwd"] == n
            and launches["swin_window_attn_fwd"] == launches["flash_attn_fwd"] == 0):
        raise AssertionError(f"the {arch} training step on the card disagrees with the CPU: {res}")


def run_stages_1_and_3(dev):
    """B1's backward, the MinVIS and CTVIS steps GPU against CPU, the three
    full-width training slices and the MinVIS overfit: (the backward's
    forms, the slices' results by phase)."""
    b1b = phase_b1_backward(dev)
    phase_stage_step_parity(dev, "minvis")
    phase_stage_step_parity(dev, "ctvis")
    stages = {phase: phase_train_slice(dev, arch, phase, STAGE_UNTIMED, STAGE_TIMED)
              for arch, phase in (("minvis", "minvis_train_slice"), ("ctvis", "ctvis_train_slice"),
                                  ("dvis_offline", "offline_train_slice"))}
    phase_train_overfit(dev, "minvis", "minvis_train_overfit")
    return b1b, stages


def run_segmenter_training(dev):
    """The segmenters trained with the ViT-L and Swin backbones and on COCO
    pseudo-videos: the four small step-parity phases (ViT-Adapter and Swin
    MinVIS, Mask2Former, Video Mask2Former), the ViT-L MinVIS and CTVIS
    slices at the full width of ``configs/dvis/{minvis,ctvis}_vitl_ytvis19.yaml``
    (5 frames of 480x768, the trunk frozen, B1 forward and backward in the
    encoder and the six extractors), the Mask2Former and Video Mask2Former
    slices at the full width of ``maskformer_r50_coco.yaml`` and
    ``video_maskformer_r50_coco_joint.yaml`` (8 COCO images as clips of 1
    and 2 rotated frames, then one step with large-scale jitter), and 100
    steps of a tiny Mask2Former whose loss must fall: the slices' results by
    phase."""
    from dvis_plus_tpu_torch.config import ctvis_vitl_ytvis19, minvis_vitl_ytvis19

    phase_stage_step_parity(dev, "minvis", "vitl_minvis_train_step_parity", VIT_TINY)
    phase_stage_step_parity(dev, "minvis", "swin_minvis_train_step_parity", SWIN_TINY)
    phase_stage_step_parity(dev, "maskformer", "maskformer_train_step_parity", T=1)
    phase_stage_step_parity(dev, "video_maskformer", "video_maskformer_train_step_parity")
    slices = {}
    for arch, phase, preset in (("minvis", "vitl_minvis_train_slice", minvis_vitl_ytvis19),
                                ("ctvis", "vitl_ctvis_train_slice", ctvis_vitl_ytvis19),
                                ("maskformer", "maskformer_train_slice", None),
                                ("video_maskformer", "video_maskformer_train_slice", None)):
        slices[phase] = phase_train_slice(dev, arch, phase, STAGE_UNTIMED, STAGE_TIMED, preset=preset,
                                          lsj=preset is None)
    phase_train_overfit(dev, "maskformer", "maskformer_train_overfit")
    return slices


# ---------------------------------------------------------------------------
# DVIS-DAQ training (stages 2 and 3 of its cutter, its offline refiner) and
# the segmenter trained on VIPSeg and VSPW
# ---------------------------------------------------------------------------

# the tiny DVIS-DAQ of the step-parity and overfit phases: TINY_TRAIN's
# segmenter (8 queries) under a 2-layer cutter with a table of 6 slots, 2
# background slots and 8 new-instance queries
DAQ_TRAIN_TINY = ("model.daq.num_new_ins=8", "model.daq.max_num_instances=6", "model.daq.num_slots=2")
# the full-width DVIS-DAQ online slices' schedule: the curriculum's boundary
# after step 0, stage 3 from step 2: a step of the first length in stage 2
# (timed), one of the second in stage 2 (by stage) and one of the second in
# stage 3 (its syncs counted)
DAQ_SCHEDULE = ["model.daq.steps=[1]", "model.daq.increasing_step=[2]"]
# the offline DAQ slice's clips: 10 of the YAML's 15 sampled frames, to keep
# the whole default run inside its time limit (its slot auctions dominate it)
DAQ_OFFLINE_FRAMES = 10
# the random cutter's class head x8, so that some queries score above the
# selection thresholds and some below (DAQ_HEADS without its shifts)
DAQ_TRAIN_HEADS = (("tracker.class_embed", 8.0, 0.0),)
VPS_FRAME = (720, 1280)  # the synthetic VIPSeg and VSPW frames of the full-width slices


def write_vps_vss(root, task, n_videos, length, H, W):
    """``dvis_plus_tpu_torch/tools/synth_data.py::make_vipseg`` (JPEG
    frames, RGB-encoded panoptic PNGs: a stuff segment and a moving thing a
    frame, 3 categories) or ``make_vspw`` (class PNGs), registered in the
    port's catalog; returns the training split's name."""
    from dvis_plus_tpu_torch.data.datasets import vps_vss
    from dvis_plus_tpu_torch.tools import synth_data

    if task == "vps":
        synth_data.make_vipseg(root, n_videos=n_videos, length=length, H=H, W=W)
        vps_vss.register_all_vipseg(root)
        return "panoVSPW_vps_video_train"
    synth_data.make_vspw(root, n_videos=n_videos, length=length, H=H, W=W)
    vps_vss.register_all_vspw(root)
    return "VSPW_vss_video_train"


@contextlib.contextmanager
def daq_decisions(model, log, replay):
    """Wrap DVIS-DAQ training's decisions: the segmenter's frame matchings,
    the new-instance matchings, the slot auctions and the queries each
    table update activates (stage 2's ranks, stage 3's and the stream's
    thresholds). Record each into ``log`` (``replay`` False), or replace it
    by the recorded one in the same order (``replay`` True). Yields the
    counts by kind: [calls, those the run would have decided otherwise]."""
    import torch

    from dvis_plus_tpu_torch.models.daq import cutter as cutter_mod
    from dvis_plus_tpu_torch.models.meta import daq as daq_mod

    counts = {k: [0, 0] for k in ("frame_match", "new_ins_match", "slot_auction", "activated")}
    recorded = iter(list(log))

    def decide(kind, value):
        counts[kind][0] += 1
        if not replay:
            log.append([v.cpu() for v in value])
            return value
        ref = next(recorded)
        counts[kind][1] += int(not all(torch.equal(a.cpu(), b) for a, b in zip(value, ref)))
        return [r.to(v.device) for r, v in zip(ref, value)]

    frame_match, new_ins_match = daq_mod.frame_match, cutter_mod.new_ins_match
    tracker = model.tracker
    auction, activate = tracker._match_slots_to_seg, tracker._activate_slots

    def matching(*a, **kw):
        res = frame_match(*a, **kw)
        return type(res)(*decide("frame_match", list(res)))

    daq_mod.frame_match = matching
    cutter_mod.new_ins_match = lambda *a, **kw: decide("new_ins_match", [new_ins_match(*a, **kw)])[0]
    tracker._match_slots_to_seg = lambda *a: decide("slot_auction", [auction(*a)])[0]
    tracker._activate_slots = lambda state, activated, *a, **kw: activate(
        state, decide("activated", [activated])[0], *a, **kw)
    try:
        yield counts
    finally:
        daq_mod.frame_match, cutter_mod.new_ins_match = frame_match, new_ins_match
        del tracker._match_slots_to_seg, tracker._activate_slots


def daq_tiny_model(cfg, seed=SEED):
    """The tiny DAQ with seeded weights, the cutter's class head x8 and its
    positional MLP x20 a layer: at the random weights' scale the
    new-instance queries (one learned embedding, told apart by their
    positional embeds alone) match their ground truths at costs within
    1e-6 of each other (tests/test_torch_daq_train.py)."""
    import torch

    from dvis_plus_tpu_torch.cli import build_model as build_arch

    torch.manual_seed(seed)
    model = build_arch(cfg.model)
    with torch.no_grad():
        model.tracker.class_embed.weight.mul_(8.0)
        for name, p in model.tracker.pos_embed.named_parameters():
            if name.endswith("weight"):
                p.mul_(20.0)
    return model


def daq_batch(B=2, T=3, H=128, W=160, N=5):
    """2 clips x 3 frames of 128x160 and their targets at the stride-4 size:
    four instances a clip, the second leaving after frame 1 and the fourth
    entering at frame 1, the last slot padding."""
    import torch

    from dvis_plus_tpu_torch.engine.trainer import Batch
    from dvis_plus_tpu_torch.losses.targets import VideoTargets

    g = torch.Generator().manual_seed(SEED)
    masks = torch.zeros(B, N, T, H // 4, W // 4, dtype=torch.bool)
    for b in range(B):
        for n in range(N - 1):
            y, x = 2 + 7 * n, 3 + 4 * b + 5 * n
            for t in range(T):
                if not ((n == 1 and t == T - 1) or (n == 3 and t == 0)):
                    masks[b, n, t, y:y + 6, x + 2 * t:x + 2 * t + 8] = True
    fv = masks.flatten(3).any(-1)
    return Batch(torch.randn(B, T, 3, H, W, generator=g),
                 VideoTargets(torch.randint(0, 5, (B, N), generator=g), masks, fv.any(-1), fv))


def daq_step_parity(dev, arch, overrides, trained):
    """One DAQ train step on the CPU, then on the card replaying the CPU's
    decisions (:func:`daq_decisions`): (losses GPU against CPU, the trained
    part's gradients as a norm, the decisions' counts, B1's launches on the
    card)."""
    import copy

    import torch

    from dvis_plus_tpu_torch.config import tiny
    from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step
    from dvis_plus_tpu_torch.losses.targets import VideoTargets
    from dvis_plus_tpu_torch.utils.draws import Draws

    cfg = tiny(arch, "model.num_classes=5", *DAQ_TRAIN_TINY, *overrides)
    batch = daq_batch()
    cpu_model = daq_tiny_model(cfg).train()
    log, out = [], []
    for d, model in ((torch.device("cpu"), cpu_model), (dev, copy.deepcopy(cpu_model).to(dev))):
        b = Batch(batch.images.to(d), VideoTargets(*(t.to(d) for t in batch.targets)))
        step, init = build_train_step(cfg, model)
        reset_launches()
        with daq_decisions(model, log, replay=d.type == "cuda") as counts:
            _, metrics = step(init(), b, Draws(torch.Generator().manual_seed(SEED + 7)))
        launches = read_launches()
        grads = torch.cat([p.grad.detach().float().cpu().flatten() for n, p in model.named_parameters()
                           if n.startswith(trained) and p.grad is not None])
        out.append(({k: float(v) for k, v in metrics.items()}, grads, counts))
    (want, gw, _), (got, gg, counts) = out
    loss_err = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want)
    return {"loss_rel_err": loss_err, "grad_rel_err_norm": ((gg - gw).norm() / gw.norm()).item(),
            "total_loss": {"cpu": want["total_loss"], "cuda": got["total_loss"]},
            "finite": all(np.isfinite(v) for v in got.values()), "decisions": counts,
            "b1_launches": launches["msdeform_fwd"], "b1_backward_launches": launches["msdeform_bwd"],
            "expected_b1": b1_per_step(cfg) * batch.images.shape[0]}


def phase_daq_train_step_parity(dev):
    """Small DVIS-DAQ training steps on the card against the CPU (the tiny
    DAQ of :func:`daq_tiny_model`, 2 clips x 3 frames of 128x160, fp32, JV,
    the same draws: a CPU generator's values moved to each device): an
    online step in stage 2, one in stage 3, one offline step (the refiner
    over the 2 best of 6 sequence rows). The card replays the CPU's
    activations, and its own matchings and slot auctions must equal the
    CPU's; the losses within 1e-4, the cutter's (offline: the refiner's)
    gradients within 1e-3 as a norm; the frozen segmenter's B1 forward on
    the card, its backward never."""
    runs = {"stage_2": daq_step_parity(dev, "daq_online", ("model.daq.increasing_step=[100]",), "tracker."),
            "stage_3": daq_step_parity(dev, "daq_online", ("model.daq.increasing_step=[0]",), "tracker."),
            "offline": daq_step_parity(dev, "daq_offline", ("model.daq.offline_topk_num=2",), "refiner.")}
    res = {"phase": "daq_train_step_parity", "clips": 2, "frames": 3, "input": [128, 160],
           "loss_tol": TRAIN_LOSS_TOL, "grad_tol": TRAIN_GRAD_TOL, **runs}
    emit(res)
    for name, r in runs.items():
        matched = all(r["decisions"][k][1] == 0 for k in ("frame_match", "new_ins_match", "slot_auction"))
        if not (r["finite"] and matched and r["loss_rel_err"] <= TRAIN_LOSS_TOL
                and r["grad_rel_err_norm"] <= TRAIN_GRAD_TOL and r["b1_launches"] == r["expected_b1"]
                and r["b1_backward_launches"] == 0):
            raise AssertionError(f"the DAQ {name} training step on the card disagrees with the CPU: {r}")


def phase_vps_train_step_parity(dev):
    """One MinVIS step on a VIPSeg batch (the port's loader and panoptic
    training mapper on a synthetic set of 128x160 frames, 2 clips of 3
    frames: a thing and a stuff slot) at small widths on the card against
    the CPU, as :func:`phase_stage_step_parity`."""
    import torch

    from dvis_plus_tpu_torch.config import TINY_TRAIN, load_config
    from dvis_plus_tpu_torch.data.build import build_combined_train_loader
    from dvis_plus_tpu_torch.engine.trainer import to_batch

    with tempfile.TemporaryDirectory() as root:
        name = write_vps_vss(root, "vps", n_videos=2, length=4, H=128, W=160)
        cfg = load_config("configs/dvis/minvis_r50_vipseg.yaml", [
            *TINY_TRAIN, "model.num_classes=5", "solver.ims_per_batch=2", "input.sampling_frame_num=3",
            "input.min_size_train=[128]", "input.max_size_train=160", f"datasets.train=[{name}]"])
        raw = next(build_combined_train_loader(cfg, seed=SEED, num_workers=0))
    batch = to_batch(raw, torch.device("cpu"))
    phase_stage_step_parity(dev, "minvis", "vps_train_step_parity", batch=batch)


def b1_daq_train_shapes(dev, bts):
    """B1's forward at the DVIS-DAQ ViT-L training steps' shapes on the
    480x768 canvas, for each of ``bts``, the frames of a clip (the frozen
    segmenter runs a clip at a time): the extractors' (bt, 1440, 16, 64)
    bf16 value (the canvas's ViT tokens; 7,560 queries) and the encoder's
    (bt, 7560, 8, 32) fp32, against the twin, timed, with the bound."""
    import torch

    out = {}
    for bt in bts:
        value, loc, attn = extractor_inputs(dev, BT=bt, grid=VIT_TRAIN_GRID)
        extractor = b1_check([VIT_TRAIN_GRID], value.to(torch.bfloat16), loc, attn.to(torch.bfloat16),
                             iters=10, plain_iters=2)
        value, loc, attn = msdeform_inputs(dev, TRAIN_LEVELS, BT=bt, M=8, D=32)
        encoder = b1_check(TRAIN_LEVELS, value, loc, attn, iters=10, plain_iters=2)
        del value, loc, attn
        out[bt] = {"extractor": {"value": [bt, 1440, 16, 64], **extractor},
                   "encoder": {"value": [bt, 7560, 8, 32], **encoder}}
        emit({"phase": "b1_daq_train_shapes", "bt": bt, **out[bt]})
    torch.cuda.empty_cache()
    return out


def run_daq_training(dev):
    """The DVIS-DAQ, VPS and VSS training phases: the small step-parity
    phases; the full-width slices (:func:`phase_train_slice`, on synthetic
    720x1280 frames, the DAQ ones under :data:`DAQ_SCHEDULE`): DVIS-DAQ
    online at ``configs/daq/daq_online_vitl_ytvis19.yaml`` (a step of the
    curriculum's 3 frames, then 5 in stage 2 by stage, then 5 in stage 3)
    and on VIPSeg at ``daq_online_vitl_vipseg.yaml`` (2 frames, then 5 in
    stages 2 and 3), offline at ``daq_offline_vitl_ytvis19.yaml`` (one step
    of :data:`DAQ_OFFLINE_FRAMES` sampled frames, by stage), MinVIS at
    ``configs/dvis/minvis_r50_{vipseg,vspw}.yaml`` with B1 and B1' checked
    at their encoder's shape; B1's forward at the DAQ ViT-L steps' shapes
    and a tiny DAQ's 60-step overfit: (the slices' results by phase, B1's
    DAQ training shapes by frames)."""
    from dvis_plus_tpu_torch.config import load_config

    phase_daq_train_step_parity(dev)
    phase_vps_train_step_parity(dev)
    slices = {}
    for phase, name, timed in (("daq_train_slice", "daq_online_vitl_ytvis19", 1),
                               ("daq_vps_train_slice", "daq_online_vitl_vipseg", 1),
                               ("daq_offline_train_slice", "daq_offline_vitl_ytvis19", 0)):
        yaml = f"configs/daq/{name}.yaml"
        data = (lambda root, clips: write_vps_vss(root, "vps", clips, 7, *VPS_FRAME)) if "vipseg" in name else None
        # the offline step is taken once, by stage (its syncs are not
        # counted: PERF.md has their count)
        opts = DAQ_SCHEDULE + ([f"input.sampling_frame_num={DAQ_OFFLINE_FRAMES}"]
                               if "offline" in name else [])
        slices[phase] = phase_train_slice(dev, load_config(yaml).model.meta_architecture, phase, 0, timed,
                                          preset=lambda y=yaml, o=opts: load_config(y, o), data=data,
                                          frame=VPS_FRAME, count_syncs=phase != "daq_offline_train_slice")
    for task, phase in (("vps", "vps_train_slice"), ("vss", "vss_train_slice")):
        yaml = f"configs/dvis/minvis_r50_{'vipseg' if task == 'vps' else 'vspw'}.yaml"
        slices[phase] = phase_train_slice(
            dev, "minvis", phase, 0, 2, preset=lambda y=yaml: load_config(y),
            data=lambda root, clips, t=task: write_vps_vss(root, t, clips, 7, *VPS_FRAME), b1_shape=True)
    # the largest clip each 480x768 DVIS-DAQ slice gave B1
    bts = sorted({max(c["value"][0] for c in slices[p]["b1_calls"])
                  for p in ("daq_train_slice", "daq_offline_train_slice")})
    b1 = b1_daq_train_shapes(dev, bts)
    phase_train_overfit(dev, "daq_online", "daq_train_overfit")
    return slices, b1


# ---------------------------------------------------------------------------
# Open-vocabulary training: the FC-CLIP segmenter, OV-DVIS++ online and
# offline, on COCO panoptic pseudo-videos and the supervised mixture
# ---------------------------------------------------------------------------

# the small OV step-parity phases: a ConvNeXt of depths (1, 1, 2, 1), CLIP
# embedding 24, at the widths of config.TINY_TRAIN
OV_TRAIN_TINY = ("model.backbone.clip_depths=[1,1,2,1]", "model.backbone.clip_dims=[16,24,32,40]",
                 "model.ov.clip_embed_dim=24")
OV_TRAIN_YAMLS = {"minvis_ov": "configs/ov/fcclip_convnextl_coco.yaml",
                  "dvis_online_ov": "configs/ov/ov_online_convnextl_coco.yaml",
                  "dvis_offline_ov": "configs/ov/ov_offline_convnextl_coco.yaml"}
# the supervised mixture's loader seed: its first three batches come from
# COCO panoptic, VIPSeg and OVIS (ratios 0.2/0.1/0.1/0.4/0.2); the fourth
# step, whose syncs are counted, reuses the OVIS batch
OV_MIXTURE_SEED = 1


def random_text_encoder(dim):
    """``--random-text``'s encoder with a seed of its own: random vectors
    seeded by the crc32 of the prompts (the CLI's hash of them changes with
    ``PYTHONHASHSEED``)."""
    import zlib

    def encode(prompts):
        rng = np.random.RandomState(zlib.crc32("\n".join(prompts).encode()))
        return rng.randn(len(prompts), dim).astype(np.float32)

    return encode


def ov_train_classifiers(cfg, dev):
    """``cli_ov.train_classifiers`` of ``cfg`` on ``dev`` (set i with void
    row i), from :func:`random_text_encoder`."""
    from dvis_plus_tpu_torch.cli_ov import train_classifiers

    return train_classifiers(cfg, random_text_encoder(cfg.model.ov.clip_embed_dim), dev)


def phase_ov_train_step_parity(dev, arch, phase="ov_train_step_parity", yaml=None, T=3):
    """One training step of the open-vocabulary ``arch`` on the card
    against the CPU: its COCO YAML (:data:`OV_TRAIN_YAMLS`) at the small
    widths (:data:`OV_TRAIN_TINY` over ``config.TINY_TRAIN``), or ``yaml`` at
    its own widths; fp32, JV matchers; the same seeded weights
    (:func:`ov_model`, the sampling offsets off the grid), batch (2 clips x
    ``T`` frames of 128x160, 3 instances a clip among the first 5 classes),
    classifier (:func:`ov_train_classifiers`) and draws; the card replays the
    CPU's masked-attention decisions. The losses, the trained parameters'
    gradients as a norm, every assignment the loss made, and B1's launches:
    forward one an encoder layer, backward as often where the segmenter
    trains (``minvis_ov``), never where it runs without gradients."""
    import copy

    import torch

    from dvis_plus_tpu_torch.config import TINY_TRAIN, load_config
    from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step
    from dvis_plus_tpu_torch.losses.targets import VideoTargets
    from dvis_plus_tpu_torch.utils.draws import Draws

    opts = ["model.compute_dtype=float32", "model.tracker.matcher_solver=jv",
            "model.criterion.matcher_solver=jv", "model.criterion.max_num_instances=4"]
    if yaml is None:
        yaml, opts = OV_TRAIN_YAMLS[arch], [*TINY_TRAIN, *OV_TRAIN_TINY, *opts]
    cfg = load_config(yaml, opts)
    B, N, H, W = 2, 4, 128, 160
    g = torch.Generator().manual_seed(SEED)
    masks = torch.zeros(B, N, T, H // 4, W // 4, dtype=torch.bool)
    for b in range(B):
        for n in range(N - 1):
            y, x = 3 + 8 * n, 2 + 5 * b + 3 * n
            for t in range(T):
                if not (n == 1 and t == 0 and T > 1):
                    masks[b, n, t, y:y + 7, x + t:x + t + 9] = True
    fv = masks.flatten(3).any(-1)
    batch = Batch(torch.randn(B, T, 3, H, W, generator=g),
                  VideoTargets(torch.randint(0, 5, (B, N), generator=g), masks, fv.any(-1), fv))
    cpu_model = ov_model(cfg, torch.device("cpu")).train()
    off_grid(cpu_model)
    out, decisions, attention = [], [], {}
    reset_launches()
    for d, model in ((torch.device("cpu"), cpu_model), (dev, copy.deepcopy(cpu_model).to(dev))):
        b = Batch(batch.images.to(d), VideoTargets(*(t.to(d) for t in batch.targets)))
        attention[d.type] = replay_attention(model.sem_seg_head.predictor, decisions,
                                             replay=d.type == "cuda")
        step, init = build_train_step(cfg, model, ov_train_classifiers(cfg, d))
        matches = []
        with recording_matches(matches):
            _, metrics = step(init(), b, Draws(torch.Generator().manual_seed(SEED + 7)))
        trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        grads = torch.cat([p.grad.detach().float().cpu().flatten() for _, p in trained])
        out.append(({k: float(v) for k, v in metrics.items()}, grads, matches,
                    sorted({n.split(".")[0] for n, _ in trained})))
    launches = read_launches()
    (want, gw, mw, parts), (got, gg, mg, _) = out
    loss_err = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want}
    grad_err = ((gg - gw).norm() / gw.norm()).item()
    same = len(mw) == len(mg) and all(torch.equal(a, b) for a, b in zip(mw, mg))
    finite = all(np.isfinite(v) for v in got.values())
    n = b1_per_step(cfg)
    expect = {"msdeform_fwd": n, "msdeform_bwd": n if arch == "minvis_ov" else 0,
              "swin_window_attn_fwd": 0, "flash_attn_fwd": 0}
    res = {"phase": phase, "arch": arch, "yaml": yaml, "backbone": cfg.model.backbone.name,
           "queries": cfg.model.transformer_decoder.num_queries, "clips": B, "frames": T, "input": [H, W],
           "trained": parts, "loss_rel_err": max(loss_err.values()), "loss_tol": TRAIN_LOSS_TOL,
           "grad_rel_err_norm": grad_err, "grad_tol": TRAIN_GRAD_TOL,
           "total_loss": {"cpu": want["total_loss"], "cuda": got["total_loss"]},
           "assignments_equal": same, "launches": launches, "expected_launches": expect,
           "attention_keys_replayed": attention["cuda"]}
    emit(res)
    if not (finite and same and max(loss_err.values()) <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
            and launches == expect):
        raise AssertionError(f"the {arch} training step on the card disagrees with the CPU: {res}")
    return res


def write_ov_mixture(root, clips, length=7, H=480, W=640):
    """The five sets of ``configs/ov/ov_online_convnextl_supervised.yaml``,
    synthetic: COCO panoptic (:func:`write_coco`), YouTube-VIS 2019 and
    2021 and OVIS (:func:`write_ytvis` with each set's classes) and VIPSeg
    (:func:`write_vps_vss`), ``clips`` images or videos each, registered
    under the YAML's names. Returns None: the phase trains the YAML's sets."""
    from dvis_plus_tpu_torch.data.datasets.categories import (
        OVIS_CLASSES,
        YTVIS_2019_CLASSES,
        YTVIS_2021_CLASSES,
    )

    write_coco(root, n_images=clips, H=H, W=W)
    for name, classes in (("ytvis_2019", YTVIS_2019_CLASSES), ("ytvis_2021", YTVIS_2021_CLASSES),
                          ("ovis", OVIS_CLASSES)):
        write_ytvis(root, name, n_videos=clips, length=length, H=H, W=W, classes=classes)
    write_vps_vss(root, "vps", clips, length, H, W)
    return None


def run_ov_training(dev):
    """The open-vocabulary training phases: the small step-parity phases
    (:func:`phase_ov_train_step_parity`) of the three architectures and of
    the FC-CLIP segmenter at the full width of
    ``configs/ov/fcclip_r50_coco.yaml`` (the CLIP RN50 trunk); then, at full
    width from synthetic data (ConvNeXt-L frozen, bf16, random text
    classifiers; :func:`phase_train_slice`): the FC-CLIP segmenter at
    ``fcclip_convnextl_coco.yaml`` (250 queries, 16 one-frame COCO panoptic
    pseudo-videos; B1 and B1' checked at the encoder's shape), OV-DVIS++
    online at ``ov_online_convnextl_coco.yaml`` (8 clips x 5 frames),
    offline at ``ov_offline_convnextl_coco.yaml`` (15 frames, clips halved
    until a step fits) and the supervised mixture at
    ``ov_online_convnextl_supervised.yaml`` (four steps: COCO panoptic,
    VIPSeg, OVIS, then OVIS again on the sync-counted step, each against
    its own classifier).
    Returns the slices' results by phase."""
    from dvis_plus_tpu_torch.config import load_config

    for arch in OV_TRAIN_YAMLS:
        phase_ov_train_step_parity(dev, arch, T=1 if arch == "minvis_ov" else 3)
    phase_ov_train_step_parity(dev, "minvis_ov", "ov_rn50_train_step_parity",
                               yaml="configs/ov/fcclip_r50_coco.yaml", T=1)
    slices = {}
    for phase, arch, steps in (("fcclip_train_slice", "minvis_ov", 1), ("ov_train_slice", "dvis_online_ov", 1),
                               ("ov_offline_train_slice", "dvis_offline_ov", 0)):
        yaml = OV_TRAIN_YAMLS[arch]
        slices[phase] = phase_train_slice(dev, arch, phase, steps, steps, preset=lambda y=yaml: load_config(y),
                                          b1_shape=arch == "minvis_ov")
    slices["ov_supervised_train_slice"] = phase_train_slice(
        dev, "dvis_online_ov", "ov_supervised_train_slice", 1, 1,
        preset=lambda: load_config("configs/ov/ov_online_convnextl_supervised.yaml"), data=write_ov_mixture,
        loader_seed=OV_MIXTURE_SEED)
    sets = [row[2] for row in slices["ov_supervised_train_slice"]["schedule_frames_stage_set"]]
    if 0 not in sets or not set(sets) - {0}:
        raise AssertionError(f"ov_supervised_train_slice reached the sets {sets}: COCO and a video set expected")
    return slices


# ---------------------------------------------------------------------------
# multi-device training and eval: data-parallel steps, video-parallel and
# multi-process eval, the object-sharded refiner (one card: two ranks or two
# eval workers share it)
# ---------------------------------------------------------------------------

DDP_YAML = "configs/dvis/dvis_online_r50_ytvis19.yaml"
DDP_STEPS = 2  # 1 untimed and 1 timed step: the whole default run keeps inside its time limit
PARALLEL_VIDEOS, PARALLEL_FRAMES = 4, 15
DIST_EVAL_FRAMES = 6  # a video of the two-rank CLI eval's synthetic set
REFINER_FRAMES, REFINER_TOL = 40, 1e-5


def ddp_cfg(out, steps=DDP_STEPS, *overrides):
    """DVIS++ online training at the YAML's full width (8 clips of 5 frames
    on the 480x768 canvas, bf16) on the synthetic set ``ytvis_ddp_train``."""
    from dvis_plus_tpu_torch.config import load_config

    return load_config(os.path.join(REPO, DDP_YAML), [
        "datasets.train=[ytvis_ddp_train]", f"solver.max_iter={steps}",
        "solver.checkpoint_period=1000000", f"output_dir={out}", *overrides])


# the two-rank step parity runs fp32, as every other parity phase: in bf16
# the card's choice of convolution algorithm by batch size (4 clips against
# 8) would move the segmenter's features by bf16 ulps
PARITY_FP32 = ("model.compute_dtype=float32",)


def set_rank_env(rank, world_size):
    os.environ.update(WORLD_SIZE=str(world_size), RANK=str(rank), LOCAL_RANK=str(rank))


def clear_rank_env():
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        os.environ.pop(k, None)


def flat_grads(model):
    import torch

    return torch.cat([p.grad.detach().float().flatten().cpu()
                      for p in model.parameters() if p.requires_grad])


def grad_gap(got, want) -> float:
    return ((got - want).norm() / want.norm()).item()


def loss_gap(got: dict, want: dict) -> float:
    """The largest relative difference of the losses (and ``total_loss``)."""
    keys = [k for k in want if k.startswith(("loss", "total_loss"))]
    assert keys and all(k in got for k in keys), (sorted(got), sorted(want))
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in keys)


@contextlib.contextmanager
def first_step_grads(out):
    """Append the flat trained gradients of the first step that each
    ``engine.trainer.build_train_step`` built inside the block takes."""
    from dvis_plus_tpu_torch.engine import trainer

    build = trainer.build_train_step

    def recording(cfg, model, *args, **kwargs):
        train_step, init = build(cfg, model, *args, **kwargs)

        def step(state, batch, draws=None):
            state, metrics = train_step(state, batch, draws)
            if state.step == 1:
                out.append(flat_grads(model))
            return state, metrics

        return step, init

    trainer.build_train_step = recording
    try:
        yield
    finally:
        trainer.build_train_step = build


def phase_ddp_train_slice(dev):
    """DVIS++ online training through the CLI's loop (``cli.do_train``) at
    ``DDP_YAML``'s full width, ``DDP_STEPS`` steps from the seeded random weights, once
    in one process and once under a process group of one NCCL rank on the
    card (``parallel.mesh.init_distributed``: the gradients and the logged
    losses all-reduced, the loader mapping the rank's block). On the first
    step, the same weights and batch, the group's losses rel <=
    ``TRAIN_LOSS_TOL`` and its gradients within ``TRAIN_GRAD_TOL`` as a
    norm of the one process's; the later steps' losses are reported beside
    them (the weights there differ by the first step's rounding, which the
    tracker's matchings can amplify); B1 forward ``b1_per_step`` a step
    (the segmenter frozen: no backward). Reports the timed steps' seconds
    (``metrics.jsonl``'s clock, a line a step, the loader's wait included),
    the peak memory and the host syncs of each whole run (sync debug mode
    plus event waits)."""
    import gc

    import torch

    from dvis_plus_tpu_torch import cli
    from dvis_plus_tpu_torch.parallel.mesh import init_distributed

    runs = {}
    with tempfile.TemporaryDirectory() as root:
        cfg = ddp_cfg(root)
        write_ytvis(root, "ytvis_ddp", n_videos=cfg.solver.ims_per_batch,
                    length=cfg.input.sampling_frame_num + 2, H=TRAIN_H, W=TRAIN_W)
        for name in ("one_process", "nccl_world_1"):
            cfg = ddp_cfg(os.path.join(root, name))
            grouped = name != "one_process"
            counts = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            if grouped:
                set_rank_env(0, 1)
                init_distributed("cuda", init_method="file://" + os.path.join(root, "rendezvous"))
            first = []
            try:
                backend = torch.distributed.get_backend() if grouped else None
                reset_launches()
                with counting_syncs(counts), first_step_grads(first):
                    state = cli.do_train(cfg, False, dev, log_every=1)
                    torch.cuda.synchronize()
                launches = read_launches()
            finally:
                if grouped:
                    torch.distributed.destroy_process_group()
                    clear_rank_env()
            with open(os.path.join(root, name, "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            runs[name] = {"rows": rows, "grads": first[0], "launches": launches,
                          "peak": torch.cuda.max_memory_allocated(dev), "syncs": counts,
                          "backend": backend}
            del state
            gc.collect()
            torch.cuda.empty_cache()
    one, ddp = runs["one_process"], runs["nccl_world_1"]
    steps = [row["step"] for row in ddp["rows"]]
    loss_err = loss_gap(ddp["rows"][0], one["rows"][0])
    later_err = [loss_gap(g, w) for g, w in zip(ddp["rows"][1:], one["rows"][1:])]
    grad_err = grad_gap(ddp["grads"], one["grads"])
    want = {"msdeform_fwd": b1_per_step(cfg) * DDP_STEPS, "msdeform_bwd": 0}
    step_s = {name: [r["rows"][i]["time"] - r["rows"][i - 1]["time"] for i in range(1, DDP_STEPS)]
              for name, r in runs.items()}
    res = {"phase": "ddp_train_slice", "yaml": DDP_YAML, "backend": ddp["backend"], "world_size": 1,
           "clips": cfg.solver.ims_per_batch, "frames": cfg.input.sampling_frame_num,
           "canvas": train_canvas(cfg), "dtype": cfg.model.compute_dtype, "steps": steps,
           "untimed_steps": 1, "step_s": step_s["nccl_world_1"], "one_process_step_s": step_s["one_process"],
           "peak_memory_bytes": ddp["peak"], "one_process_peak_memory_bytes": one["peak"],
           "host_syncs_whole_run": {"event_waits": ddp["syncs"][0], "debug_mode": ddp["syncs"][1]},
           "one_process_host_syncs_whole_run": {"event_waits": one["syncs"][0], "debug_mode": one["syncs"][1]},
           "total_loss": [r["total_loss"] for r in ddp["rows"]],
           "one_process_total_loss": [r["total_loss"] for r in one["rows"]],
           "loss_rel_err": loss_err, "loss_tol": TRAIN_LOSS_TOL, "grad_rel_err": grad_err,
           "grad_tol": TRAIN_GRAD_TOL, "later_steps_loss_rel_err": later_err, "launches": ddp["launches"]}
    emit(res)
    ok = (ddp["backend"] == "nccl" and steps == list(range(DDP_STEPS)) and loss_err <= TRAIN_LOSS_TOL
          and grad_err <= TRAIN_GRAD_TOL
          and all(ddp["launches"][k] == v for k, v in want.items()))
    if not ok:
        raise AssertionError(f"ddp_train_slice: backend {ddp['backend']}, steps {steps}, losses {loss_err}, "
                             f"gradients {grad_err}, B1 launches {ddp['launches']} (expected {want})")
    return res


@contextlib.contextmanager
def step_decisions(model, log, block=None):
    """Record into ``log`` (``block`` None) the discrete decisions of a
    DVIS++ online training step, in call order: the frozen segmenter's
    masked-attention masks (each layer's blocked keys), the tracker's
    alignments and the loss's assignments; or replay them (``block``:
    (start, size, total), this rank's clips of the recorded batch, whose
    rows it takes). A random model puts many of these near a tie (the 'wa'
    noise repeats reference rows), and the card's kernels round a batch of
    4 clips otherwise than one of 8. Returns the counts: decisions replayed
    and how many the run would have made otherwise."""
    import torch

    from dvis_plus_tpu_torch.losses import criterion
    from dvis_plus_tpu_torch.models.segmenter import transformer_decoder
    from dvis_plus_tpu_torch.models.tracker import referring_tracker

    predictor = model.sem_seg_head.predictor
    heads, match, align = predictor._prediction_heads, criterion.match, referring_tracker.match_embds
    stats = {"calls": 0, "decisions": 0, "differ": 0}

    def decide(got):
        if block is None:
            log.append(got.cpu())
            return got
        start, size, _ = block
        k = got.shape[0] // size
        ref = log[stats["calls"]][k * start:k * (start + size)].to(got.device)
        stats["calls"] += 1
        stats["decisions"] += got.numel()
        stats["differ"] += int((ref != got).sum())
        return ref

    def attention(output, mask_features, attn_size):
        x, masks, additive = heads(output, mask_features, attn_size)
        blocked = decide(additive != 0)
        return x, masks, torch.zeros_like(additive).masked_fill(blocked, transformer_decoder._NEG_INF)

    predictor._prediction_heads = attention
    criterion.match = lambda *a, **kw: decide(match(*a, **kw))
    referring_tracker.match_embds = lambda *a, **kw: decide(align(*a, **kw))
    try:
        yield stats
    finally:
        del predictor._prediction_heads
        criterion.match, referring_tracker.match_embds = match, align


def _parallel_rank(rank, world_size, root):
    """A spawned rank of :func:`run_two_ranks` on the card, gloo: one
    training step on its block of the batch in ``root``, then the CLI's eval
    of the synthetic YouTube-VIS set; writes what it saw."""
    import pickle

    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dvis_plus_tpu_torch import cli
    from dvis_plus_tpu_torch.engine.trainer import build_train_step, to_batch
    from dvis_plus_tpu_torch.parallel.mesh import init_distributed, shard_batch

    set_rank_env(rank, world_size)
    dev = init_distributed("cuda", backend="gloo", init_method="file://" + os.path.join(root, "rendezvous"))
    out = {"device": str(dev), "backend": torch.distributed.get_backend()}
    cfg = ddp_cfg(os.path.join(root, "unused"), DDP_STEPS, *PARITY_FP32)
    torch.manual_seed(cfg.seed)
    model = cli.build_model(cfg.model).to(dev)
    train_step, init = build_train_step(cfg, model)
    with open(os.path.join(root, "batch.pkl"), "rb") as f:
        raw = shard_batch(pickle.load(f), rank, world_size)
    decisions = torch.load(os.path.join(root, "decisions.pt"))
    blk = raw["block"]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with step_decisions(model, decisions, (blk.start, blk.size, blk.total)) as replayed:
        _, metrics = train_step(init(), to_batch(raw, dev))
    torch.cuda.synchronize()
    out["step_s"] = time.perf_counter() - t0
    out["replayed"] = replayed
    out["train_launches"] = read_launches()
    out["clips"] = int(raw["images"].shape[0])
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    if rank == 0:
        torch.save(flat_grads(model), os.path.join(root, "ddp_grads.pt"))
    del model, train_step
    torch.cuda.empty_cache()
    os.environ["DVIS_DATASETS"] = os.path.join(root, "eval")
    reset_launches()
    out["eval"] = cli.main(eval_argv(os.path.join(root, "eval_two_ranks")))["ytvis_2019_val"]
    out["eval_launches"] = read_launches()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def eval_argv(out):
    return ["--config-file", os.path.join(REPO, DDP_YAML), "--eval-only", "--device", "cuda",
            "datasets.test=[ytvis_2019_val]", f"output_dir={out}"]


def run_two_ranks(dev):
    """Two ranks spawned on the one card, gloo (NCCL takes one card a rank):
    ``ddp2_train_step_parity``, a DVIS++ online step at ``DDP_YAML``'s full
    width in fp32 (``PARITY_FP32``) over the loader's first batch of 8
    clips, 4 a rank, against one process's step over the 8 (losses rel <=
    ``TRAIN_LOSS_TOL``, gradients within ``TRAIN_GRAD_TOL`` as a norm, the
    same draws from the step's generator, each rank replaying its rows of
    the one process's discrete decisions, ``step_decisions``); then ``dist_eval_slice``, the CLI's eval of a synthetic
    YouTube-VIS set of ``PARALLEL_VIDEOS`` videos at the YAML's width, each
    rank its stripe of the videos: rank 0's ``results.json`` must hold the
    one-process CLI's rows rank by rank (rank 0's videos, then rank 1's)
    and the same AP."""
    import gc
    import pickle

    import torch

    from dvis_plus_tpu_torch import cli
    from dvis_plus_tpu_torch.data.build import build_combined_train_loader
    from dvis_plus_tpu_torch.data.catalog import get_dataset
    from dvis_plus_tpu_torch.data.datasets.categories import YTVIS_2019_CLASSES
    from dvis_plus_tpu_torch.engine.trainer import build_train_step, to_batch

    with tempfile.TemporaryDirectory() as root:
        cfg = ddp_cfg(os.path.join(root, "unused"), DDP_STEPS, *PARITY_FP32)
        write_ytvis(root, "ytvis_ddp", n_videos=cfg.solver.ims_per_batch,
                    length=cfg.input.sampling_frame_num + 2, H=TRAIN_H, W=TRAIN_W)
        raw = next(build_combined_train_loader(cfg, seed=cfg.seed))
        with open(os.path.join(root, "batch.pkl"), "wb") as f:
            pickle.dump(raw, f)
        torch.manual_seed(cfg.seed)
        model = cli.build_model(cfg.model).to(dev)
        train_step, init = build_train_step(cfg, model)
        decisions = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with step_decisions(model, decisions):
            _, metrics = train_step(init(), to_batch(raw, dev))
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        torch.save(decisions, os.path.join(root, "decisions.pt"))
        del decisions
        want_metrics, want_grads = {k: float(v) for k, v in metrics.items()}, flat_grads(model)
        del model, train_step
        gc.collect()
        torch.cuda.empty_cache()
        # the eval set, with its ground truth, and the one-process CLI run
        from dvis_plus_tpu_torch.tools import synth_data

        synth_data.make_ytvis(os.path.join(root, "eval"), "ytvis_2019", YTVIS_2019_CLASSES, splits=("valid",),
                              n_videos=PARALLEL_VIDEOS, length=DIST_EVAL_FRAMES, H=H_IN, W=W_IN)
        os.environ["DVIS_DATASETS"] = os.path.join(root, "eval")
        t0 = time.perf_counter()
        alone = cli.main(eval_argv(os.path.join(root, "eval_one")))["ytvis_2019_val"]
        alone_s = time.perf_counter() - t0
        ids = [r["video_id"] for r in get_dataset("ytvis_2019_val")]
        t0 = time.perf_counter()
        ctx = torch.multiprocessing.start_processes(_parallel_rank, args=(2, root), nprocs=2, join=False,
                                                    start_method="spawn")
        while not ctx.join():
            pass
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        ddp_grads = torch.load(os.path.join(root, "ddp_grads.pt"))
        rows = {}
        for name in ("eval_one", "eval_two_ranks"):
            with open(os.path.join(root, name, "inference", "ytvis_2019_val", "results.json")) as f:
                rows[name] = json.load(f)
    loss_err = max(loss_gap(r["metrics"], want_metrics) for r in ranks)
    grad_err = grad_gap(ddp_grads, want_grads)
    b1 = b1_per_step(cfg)
    train_ok = (all(r["backend"] == "gloo" and r["device"] == "cuda:0" and r["clips"] == 4
                    and r["replayed"]["decisions"] > 0 for r in ranks)
                and loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
                and all(r["train_launches"]["msdeform_fwd"] == b1 for r in ranks))
    train = {"phase": "ddp2_train_step_parity", "yaml": DDP_YAML, "backend": "gloo", "world_size": 2,
             "device": [r["device"] for r in ranks], "clips_per_rank": [r["clips"] for r in ranks],
             "frames": cfg.input.sampling_frame_num, "canvas": train_canvas(cfg), "dtype": cfg.model.compute_dtype,
             "loss_rel_err": loss_err, "loss_tol": TRAIN_LOSS_TOL, "grad_rel_err": grad_err,
             "grad_tol": TRAIN_GRAD_TOL, "total_loss": {"one_process": want_metrics["total_loss"],
                                                        "ranks": [r["metrics"]["total_loss"] for r in ranks]},
             "decisions_replayed": [r["replayed"]["decisions"] for r in ranks],
             "decisions_the_ranks_made_otherwise": [r["replayed"]["differ"] for r in ranks],
             "step_s": [r["step_s"] for r in ranks], "one_process_step_s": one_s,
             "spawn_and_both_phases_s": spawn_s,
             "launches": {k: sum(r["train_launches"][k] for r in ranks) for k in ranks[0]["train_launches"]}}
    emit(train)
    by_video = {v: [r for r in rows["eval_one"] if r["video_id"] == v] for v in ids}
    want_rows = [r for v in ids[0::2] + ids[1::2] for r in by_video[v]]
    eval_ok = (rows["eval_two_ranks"] == want_rows and ranks[0]["eval"]["AP"] == alone["AP"]
               and all(r["eval"]["predictions"] == len(rows["eval_one"]) for r in ranks)
               and sum(r["eval_launches"]["msdeform_fwd"] for r in ranks) > 0)
    dist_eval = {"phase": "dist_eval_slice", "yaml": DDP_YAML, "backend": "gloo", "world_size": 2,
                 "videos": len(ids), "frames": DIST_EVAL_FRAMES, "input": [H_IN, W_IN],
                 "rows": len(rows["eval_two_ranks"]),
                 "rows_rank_by_rank": rows["eval_two_ranks"] == want_rows,
                 "ap": {"one_process": alone["AP"], "two_ranks": ranks[0]["eval"].get("AP")},
                 "one_process_s": alone_s,
                 "launches": {k: sum(r["eval_launches"][k] for r in ranks) for k in ranks[0]["eval_launches"]}}
    emit(dist_eval)
    if not (train_ok and eval_ok):
        raise AssertionError(f"two ranks on the card: training ok {train_ok} (losses {loss_err}, gradients "
                             f"{grad_err}), eval ok {eval_ok}")
    return train, dist_eval


def phase_parallel_eval_slice(dev):
    """``engine.parallel_eval.run_device_parallel`` over the card named twice
    (two worker threads, each with its copy of the model), DVIS++ online at
    ``DDP_YAML``'s full width, bf16, ``PARALLEL_VIDEOS`` videos of
    ``PARALLEL_FRAMES`` frames at 480x640, the default eval settings: the
    ``results.json`` bytes must equal the sequential run's, and B1 launch
    as often."""
    import torch

    from dvis_plus_tpu_torch.config import load_config
    from dvis_plus_tpu_torch.engine.inference import run_vis_inference
    from dvis_plus_tpu_torch.engine.parallel_eval import run_device_parallel
    from dvis_plus_tpu_torch.evaluation.evaluators import YTVISEvaluator

    cfg = load_config(os.path.join(REPO, DDP_YAML))
    model = build_model(cfg, dev)
    videos = list(synthetic_videos(PARALLEL_VIDEOS, PARALLEL_FRAMES, H_IN, W_IN, H_OUT, W_OUT, SEED + 21))
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for name, devices in (("sequential", None), ("two_workers", [dev, dev])):
            ev = YTVISEvaluator("synthetic", os.path.join(root, name))
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_device_parallel(cfg, lambda m, ld, e: run_vis_inference(cfg, m, ld, e),
                                lambda i, n: iter(videos[i::n]), ev, model, devices)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            with open(ev.write_results(), "rb") as f:
                out[name] = (f.read(), seconds, read_launches())
    (want, seq_s, seq_l), (got, par_s, par_l) = out["sequential"], out["two_workers"]
    res = {"phase": "parallel_eval_slice", "yaml": DDP_YAML, "devices": [str(dev)] * 2,
           "videos": PARALLEL_VIDEOS, "frames": PARALLEL_FRAMES, "input": [H_IN, W_IN],
           "dtype": cfg.model.compute_dtype, "results_json_bytes": len(got), "equal": got == want,
           "sequential_s": seq_s, "two_workers_s": par_s, "launches": par_l, "sequential_launches": seq_l}
    emit(res)
    if not (got == want and par_l == seq_l and par_l["msdeform_fwd"] > 0):
        raise AssertionError(f"parallel_eval_slice: results.json equal {got == want}, B1 launches "
                             f"{par_l} against {seq_l}")
    return res


def phase_refiner_sharded_parity(dev):
    """The object-sharded refiner pass (``parallel.sp``) over the card named
    twice against the plain ``embed_pass``: the refiner of
    ``configs/dvis/dvis_offline_r50_ytvis19.yaml`` at full width (as
    ``DVISOffline`` builds it), the YAML's queries, ``REFINER_FRAMES``
    frames, fp32, seeded weights and inputs; every output rel <=
    ``REFINER_TOL``; both timed."""
    import torch

    from dvis_plus_tpu_torch.config import load_config
    from dvis_plus_tpu_torch.models.refiner.temporal_refiner import TemporalRefiner
    from dvis_plus_tpu_torch.parallel.sp import refiner_embed_pass_sharded

    m = load_config(os.path.join(REPO, "configs/dvis/dvis_offline_r50_ytvis19.yaml")).model
    td = m.transformer_decoder
    C = td.hidden_dim * (2 if td.reid_branch else 1)
    torch.manual_seed(SEED)
    refiner = TemporalRefiner(m.num_classes, C, m.refiner.feedforward_dim, m.refiner.num_heads,
                              m.refiner.num_layers, td.hidden_dim).to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(SEED)
    ie = torch.randn(1, REFINER_FRAMES, td.num_queries, C, device=dev, generator=g)
    fe = torch.randn(1, REFINER_FRAMES, td.num_queries, C, device=dev, generator=g)
    devices = [dev, dev]
    with torch.no_grad():
        want = refiner.embed_pass(ie, fe)
        got = refiner_embed_pass_sharded(refiner, ie, fe, devices)
        errs = {k: ((got[k] - want[k]).abs().max() / want[k].abs().max()).item() for k in want}
        plain_ms = cuda_ms(lambda: refiner.embed_pass(ie, fe), iters=5)
        sharded_ms = cuda_ms(lambda: refiner_embed_pass_sharded(refiner, ie, fe, devices), iters=5)
    res = {"phase": "refiner_sharded_parity", "hidden_dim": C, "layers": m.refiner.num_layers,
           "queries": td.num_queries, "frames": REFINER_FRAMES, "shards": len(devices),
           "devices": [str(d) for d in devices], "dtype": "float32", "rel_err": errs, "tol": REFINER_TOL,
           "plain_ms": plain_ms, "sharded_ms": sharded_ms}
    emit(res)
    if not (sorted(got) == sorted(want) and max(errs.values()) <= REFINER_TOL):
        raise AssertionError(f"refiner_sharded_parity: {errs}")
    return res


def run_parallel(dev):
    """The multi-device phases; returns the training and eval paths'
    lines by phase (their kernel launches feed the ``kernels`` line)."""
    paths = {"ddp_train_slice": phase_ddp_train_slice(dev)}
    paths["ddp2_train_step_parity"], paths["dist_eval_slice"] = run_two_ranks(dev)
    paths["parallel_eval_slice"] = phase_parallel_eval_slice(dev)
    phase_refiner_sharded_parity(dev)
    return paths


DEMO_YAML = "configs/dvis/dvis_online_r50_ytvis19.yaml"
DEMO_FRAMES, DEMO_H, DEMO_W = 30, 720, 1280
DEMO_CHUNK, DEMO_PARITY_FRAMES = 10, 6
DEMO_PIXEL_AGREE = 0.999  # decoded overlays equal, card against CPU
FAST_SOFTMAX_TOL = 1e-2  # B2 against the bf16-score plain path


def demo_frames(root, n, H, W):
    """``n`` seeded JPEG frames of HxW under ``root``: smooth colour ramps
    with a moving block (noise would make every overlay pixel a JPEG edge)."""
    import cv2

    os.makedirs(root)
    y, x = np.mgrid[0:H, 0:W]
    for t in range(n):
        img = np.stack([(x * 255 // W), (y * 255 // H), np.full_like(x, (37 * t) % 256)], -1)
        img[H // 4 : H // 2, W // 8 + 8 * t : W // 3 + 8 * t] = (200, 60, 30)
        cv2.imwrite(os.path.join(root, f"{t:05d}.jpg"), img.astype(np.uint8))
    return root


def overlay_agreement(a_dir, b_dir, frames_dir) -> dict:
    """Decoded overlays of two runs: the share of pixels equal in all three
    channels, over every frame, and the share the first run drew on (that
    differ from the input frame)."""
    import cv2

    names = sorted(os.listdir(a_dir))
    if names != sorted(os.listdir(b_dir)):
        raise AssertionError(f"overlay sets differ: {names} vs {sorted(os.listdir(b_dir))}")
    equal = drawn = total = 0
    for n in names:
        a, b = cv2.imread(os.path.join(a_dir, n)), cv2.imread(os.path.join(b_dir, n))
        equal += int((a == b).all(-1).sum())
        drawn += int((a != cv2.imread(os.path.join(frames_dir, n))).any(-1).sum())
        total += a.shape[0] * a.shape[1]
    return {"frames": len(names), "pixel_agree": equal / total, "drawn": drawn / total}


def phase_demo_slice(dev):
    """The demo (``python -m dvis_plus_tpu_torch.demo``) at the full width of
    ``configs/dvis/dvis_online_r50_ytvis19.yaml`` (bf16), seeded random
    weights saved as a ``.pth`` and given as ``weights=``, on 30 synthetic
    JPEG frames of 720x1280: the whole-video mode, then ``--chunk-size 10``
    (the tracker's carry across chunks), after an untimed warm-up run.
    frames/s are the demo's own, end to end (JPEG decode and resize,
    windows, top-K, overlays written as JPEG); B1 launches 6 a window. Then
    the first 6 frames in fp32 (JV matcher, every top-K instance drawn) on
    the card against ``--device cpu``, the card replaying the CPU's
    masked-attention decisions, the frames and so the overlays as PNG: the
    decoded overlays equal on at least 99.9 % of pixels, and drawn on at
    least half of them."""
    import cv2
    import torch

    from dvis_plus_tpu_torch import cli, demo
    from dvis_plus_tpu_torch.config import load_config

    cfg = load_config(os.path.join(REPO, DEMO_YAML))
    W_sz = cfg.test.window_size
    out = {"phase": "demo_slice", "yaml": DEMO_YAML, "frames": DEMO_FRAMES, "input": [DEMO_H, DEMO_W],
           "compute_dtype": cfg.model.compute_dtype, "window": W_sz}
    with tempfile.TemporaryDirectory() as tmp:
        torch.manual_seed(SEED)
        pth = os.path.join(tmp, "weights.pth")
        torch.save(cli.build_model(cfg.model).state_dict(), pth)
        frames = demo_frames(os.path.join(tmp, "frames"), DEMO_FRAMES, DEMO_H, DEMO_W)
        warm = os.path.join(tmp, "warm")
        os.makedirs(warm)
        for i in range(W_sz):
            os.link(os.path.join(frames, f"{i:05d}.jpg"), os.path.join(warm, f"{i:05d}.jpg"))

        def run(name, frame_dir, *extra, device="cuda"):
            res = demo.main(["--config-file", os.path.join(REPO, DEMO_YAML), "--input", frame_dir,
                             "--output", os.path.join(tmp, name), "--device", device, *extra,
                             f"weights={pth}"])
            return res, len(os.listdir(os.path.join(tmp, name)))

        expect_windows = {"whole": -(-DEMO_FRAMES // W_sz),
                          "chunked": sum(-(-min(DEMO_CHUNK, DEMO_FRAMES - s) // W_sz)
                                         for s in range(0, DEMO_FRAMES, max(DEMO_CHUNK, W_sz)))}
        run("warm", warm)  # cuDNN autotuning and the allocator, not timed
        for mode, extra in (("whole", ()), ("chunked", ("--chunk-size", str(DEMO_CHUNK)))):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            res, written = run(mode, frames, *extra)
            torch.cuda.synchronize()
            launches = read_launches()
            expect = {"msdeform_fwd": cfg.model.pixel_decoder.transformer_enc_layers * expect_windows[mode],
                      "msdeform_bwd": 0, "swin_window_attn_fwd": 0, "flash_attn_fwd": 0}
            out[mode] = {"fps": res["fps"], "seconds": res["seconds"], "overlays": written,
                         "chunked": res["chunked"], "windows": expect_windows[mode],
                         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "launches": launches, "expected_launches": expect}
            if not (written == DEMO_FRAMES and res["chunked"] == (mode == "chunked")
                    and launches == expect):
                emit(out)
                raise AssertionError(f"demo {mode} run failed its check: {out[mode]}")
        out["launches"] = out["whole"]["launches"]
        # fp32 parity: the first frames, card against CPU, as lossless PNG
        # (the demo writes each overlay in its frame's format): a JPEG
        # overlay spreads a flipped mask pixel over its 16x16 block
        first = os.path.join(tmp, "first")
        os.makedirs(first)
        for i in range(DEMO_PARITY_FRAMES):
            cv2.imwrite(os.path.join(first, f"{i:05d}.png"), cv2.imread(os.path.join(frames, f"{i:05d}.jpg")))
        # every top-K instance drawn: the random model's scores lie below
        # the default threshold of 0.3
        fp32 = ("--confidence-threshold", "0", "model.compute_dtype=float32",
                "model.tracker.matcher_solver=jv")
        # the card replays the CPU's masked-attention decisions (the random
        # model's mask logits lie near the threshold; the line counts the
        # keys the card would have decided otherwise)
        decisions, attention = [], {}

        def recording(device):
            def wrap(build):
                def build_replaying(model_cfg):
                    model = build(model_cfg)
                    attention[device] = replay_attention(model.sem_seg_head.predictor, decisions,
                                                         replay=device == "cuda")
                    return model
                return build_replaying
            return [(cli, "build_model", wrap)]

        t0 = time.perf_counter()
        with wrapping(recording("cpu")):
            run("parity_cpu", first, *fp32, device="cpu")
        cpu_s = time.perf_counter() - t0
        with wrapping(recording("cuda")):
            run("parity_cuda", first, *fp32)
        out["parity"] = {"frames": DEMO_PARITY_FRAMES, "cpu_s": cpu_s,
                         "attention_keys_replayed": attention["cuda"],
                         **overlay_agreement(os.path.join(tmp, "parity_cuda"), os.path.join(tmp, "parity_cpu"),
                                             first),
                         "tol": DEMO_PIXEL_AGREE}
    emit(out)
    if out["parity"]["pixel_agree"] < DEMO_PIXEL_AGREE or out["parity"]["drawn"] < 0.5:
        raise AssertionError(f"the demo's overlays on the card disagree with the CPU's: {out['parity']}")
    return out


def phase_fpn_slice(dev):
    """The FPN pixel decoder (``model.pixel_decoder.name=fpn``) on the full
    width of ``configs/dvis/dvis_online_r50_ytvis19.yaml``: eval over 2
    videos x 15 frames of 480x640 (bf16; B1 never launches: the FPN decoder
    has no deformable attention), model fps and peak memory; then a small
    fp32 MinVIS training step with the FPN decoder trained, card against
    CPU (``phase_stage_step_parity``: losses 1e-4, the decoders' gradients
    1e-3 as a norm, assignments equal)."""
    from dvis_plus_tpu_torch.config import load_config

    cfg = load_config(os.path.join(REPO, DEMO_YAML), ["model.pixel_decoder.name=fpn"])
    res, rows_ok, _ = timed_slice(cfg, dev)
    expect = {"msdeform_fwd": 0, "msdeform_bwd": 0, "swin_window_attn_fwd": 0, "flash_attn_fwd": 0}
    res = {"phase": "fpn_slice", "yaml": DEMO_YAML, "pixel_decoder": "fpn", **res,
           "expected_launches": expect}
    emit(res)
    if not (rows_ok and res["launches"] == expect):
        raise AssertionError(f"FPN slice check failed: {res}")
    phase_stage_step_parity(dev, "minvis", "fpn_train_step_parity", ("model.pixel_decoder.name=fpn",))
    return res


def window_attention_inputs(mod, x, mask):
    """q, k, v (views of the qkv output), the (H, N, N) fp32 bias and the
    mask a Swin ``WindowAttention`` hands the kernel for input ``x``."""
    C, H, N = mod.dim, mod.num_heads, x.shape[1]
    q, k, v = mod.qkv(x).split(C, dim=-1)
    bias = mod.relative_position_bias_table[mod.relative_position_index.reshape(-1)]
    return q, k, v, bias.reshape(N, N, H).permute(2, 0, 1).float().contiguous(), mask


def phase_swin_fast_softmax(dev):
    """``backbone.swin_fast_softmax`` on the full-width Swin-L DVIS++
    offline model (bf16): one eval window of 5 frames at 480x640 with the
    key set, B2 launching for every block (24) and B1 for every encoder
    layer (6), the JAX precedence of the fused kernel over the bf16 scores.
    The inputs that window gave the first two blocks of each stage
    (unshifted and shifted) are then held: B2 against the port's
    bf16-score plain path (``window_attention_fast_softmax_torch``) on the
    same tensors, within 1e-2 of its largest output, both timed. Beside
    them, at each stage's shape, unit-variance q, k and v: the same two,
    and the fp32-score twin, not held (bf16 scores of order 4 round to
    steps a few percent of their exp: the gap is the bf16-score path's own,
    and the fp32-score twin sits as far from it as B2 does)."""
    import torch

    from dvis_plus_tpu_torch.config import dvis_offline_swinl_ytvis19
    from dvis_plus_tpu_torch.engine.inference import _online_video
    from dvis_plus_tpu_torch.models.backbones.swin import WindowAttention
    from dvis_plus_tpu_torch.ops import swin_window_attn

    cfg = dvis_offline_swinl_ytvis19()
    cfg.model.backbone.swin_fast_softmax = True
    model = build_model(cfg, dev)
    captured = {}

    def hook(stage, shifted):
        def pre(mod, args):
            if (stage, shifted) not in captured:
                captured[stage, shifted] = (mod, args[0].detach().clone(),
                                            None if len(args) < 2 else args[1])
        return pre

    handles = []
    for s, layer in enumerate(model.backbone.layers):
        for b in (0, 1):
            attn = layer.blocks[b].attn
            assert isinstance(attn, WindowAttention) and attn.fast_softmax
            handles.append(attn.register_forward_pre_hook(hook(s, b == 1)))
    W_sz = cfg.test.window_size
    images = next(synthetic_videos(1, W_sz, H_IN, W_IN, H_OUT, W_OUT, SEED + 5))["images"]
    with torch.inference_mode():
        _online_video(cfg, model, images, W_sz)  # warm-up (cuDNN autotuning, allocator)
        captured.clear()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits, masks, aux = _online_video(cfg, model, images, W_sz)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        launches = read_launches()
    for h in handles:
        h.remove()
    expect = {"msdeform_fwd": cfg.model.pixel_decoder.transformer_enc_layers, "msdeform_bwd": 0,
              "swin_window_attn_fwd": sum(cfg.model.backbone.swin_depths), "flash_attn_fwd": 0}
    forms = []
    g = torch.Generator(device="cpu").manual_seed(SEED + 6)
    with torch.inference_mode():
        for (stage, shifted), (mod, x, mask) in sorted(captured.items(), key=lambda kv: kv[0]):
            q, k, v, bias, mask = window_attention_inputs(mod, x, mask)
            H = mod.num_heads
            kernel = lambda: swin_window_attn.window_attention(q, k, v, bias, mask, H, fast_softmax=True)  # noqa: E731
            plain = lambda: swin_window_attn.window_attention_fast_softmax_torch(q, k, v, bias, mask, H)  # noqa: E731
            got, want = kernel().float(), plain().float()
            err = (got - want).abs().max().item()
            f = {"stage": stage, "shifted": shifted, "B_": q.shape[0], "heads": H, "N": q.shape[1],
                 "dtype": str(q.dtype).split(".")[1], "max_abs_err": err,
                 "rel_err": err / want.abs().max().item(), "tol": FAST_SOFTMAX_TOL,
                 "ms": cuda_ms(kernel, 10, KERNEL_REPS), "plain_ms": cuda_ms(plain, 5, KERNEL_REPS)}
            f["bound_ms"], f["bound_by"] = bound(
                (q, k, v, got.to(q.dtype), bias) + (() if mask is None else (mask,)),
                4 * q.shape[0] * H * q.shape[1] ** 2 * 32, q.dtype)
            # unit-variance inputs at the same shape: the gap is the definition's
            qkv = torch.randn(q.shape[0], q.shape[1], 3 * mod.dim, generator=g).to(dev, torch.bfloat16)
            uq, uk, uv = qkv.split(mod.dim, dim=-1)
            u_plain = swin_window_attn.window_attention_fast_softmax_torch(uq, uk, uv, bias, mask, H).float()
            u_kernel = swin_window_attn.window_attention(uq, uk, uv, bias, mask, H, fast_softmax=True).float()
            u_twin = swin_window_attn.window_attention_torch(uq, uk, uv, bias, mask, H).float()
            scale = u_plain.abs().max().item()
            f["unit_inputs_rel_err"] = {"kernel": (u_kernel - u_plain).abs().max().item() / scale,
                                        "fp32_score_twin": (u_twin - u_plain).abs().max().item() / scale}
            forms.append(f)
            del qkv, uq, uk, uv
    finite = all(torch.isfinite(t.float()).all().item() for t in (logits, masks, aux))
    res = {"phase": "swin_fast_softmax", "backbone": cfg.model.backbone.name,
           "meta_architecture": cfg.model.meta_architecture, "compute_dtype": cfg.model.compute_dtype,
           "frames": W_sz, "input": [H_IN, W_IN], "window_s": window_s, "finite": finite,
           "launches": launches, "expected_launches": expect, "forms": forms}
    emit(res)
    if not (finite and launches == expect and len(forms) == 8
            and all(f["rel_err"] <= FAST_SOFTMAX_TOL for f in forms)):
        raise AssertionError(f"swin_fast_softmax check failed: {res}")
    return res


def run_last_modules(dev) -> dict:
    """The demo, the FPN pixel decoder and the Swin bf16-score knob: their
    results by phase."""
    return {"demo_slice": phase_demo_slice(dev), "fpn_slice": phase_fpn_slice(dev),
            "swin_fast_softmax": phase_swin_fast_softmax(dev)}


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
    if "--b1-backward" in sys.argv[1:]:
        phase_b1_backward(dev)
        return 0
    if "--daq" in sys.argv[1:]:
        phase_daq_slice_parity(dev)
        phase_daq_slice(dev, "daq_online", "daq_slice")
        phase_daq_slice(dev, "daq_offline", "daq_offline_slice")
        return 0
    if "--train" in sys.argv[1:]:
        phase_train_step_parity(dev)
        phase_train_slice(dev, b1_shape=True)
        phase_train_overfit(dev)
        run_stages_1_and_3(dev)
        run_segmenter_training(dev)
        emit({"phase": "wall", "seconds": time.perf_counter() - start})
        return 0
    if "--train-segmenters" in sys.argv[1:]:
        phase_b1_backward(dev)
        run_segmenter_training(dev)
        emit({"phase": "wall", "seconds": time.perf_counter() - start})
        return 0
    if "--train-daq" in sys.argv[1:]:
        run_daq_training(dev)
        emit({"phase": "wall", "seconds": time.perf_counter() - start})
        return 0
    if "--train-ov" in sys.argv[1:]:
        run_ov_training(dev)
        emit({"phase": "wall", "seconds": time.perf_counter() - start})
        return 0
    if "--parallel" in sys.argv[1:]:
        run_parallel(dev)
        emit({"phase": "wall", "seconds": time.perf_counter() - start})
        return 0
    if "--demo" in sys.argv[1:]:
        run_last_modules(dev)
        emit({"phase": "wall", "seconds": time.perf_counter() - start})
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
    last = run_last_modules(dev)
    phase_train_step_parity(dev)
    train = phase_train_slice(dev, b1_shape=True)
    phase_train_overfit(dev)
    b1b, stages = run_stages_1_and_3(dev)
    stages.update(run_segmenter_training(dev))
    daq_train, b1_daq = run_daq_training(dev)
    stages.update(daq_train)
    stages.update(run_ov_training(dev))
    stages.update(run_parallel(dev))

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
    b1_shapes["train_encoder_480x768"] = train["b1_train_encoder"]
    for bt, forms in b1_daq.items():
        b1_shapes[f"daq_vitl_train_extractor_bt{bt}"] = forms["extractor"]
        b1_shapes[f"daq_vitl_train_encoder_bt{bt}"] = forms["encoder"]
    # MinVIS on VIPSeg and VSPW, and the FC-CLIP segmenter on COCO panoptic:
    # B1 and B1' at their encoder's training shape
    for name, phase in (("vps", "vps_train_slice"), ("vss", "vss_train_slice"),
                        ("fcclip", "fcclip_train_slice")):
        r = stages[phase]
        b1_shapes[f"{name}_train_encoder"] = r["b1_train_encoder"]
        b1_shapes[f"{name}_train_encoder_clamped_r7"] = r["b1_train_encoder_r7"]
        b1b += [{"shape": f"{name}_train_encoder", "offsets": "uniform", **f} for f in r["b1_backward"]]
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
    # B1's backward: the training encoder's shape, exact form, fp32, uniform offsets
    b1b_main = next(f for f in b1b if f["shape"] == "train_encoder_480x768"
                    and f["offsets"] == "uniform" and f["radius"] is None)
    paths = {"slice": runs["exact"], "swinl_slice": swinl, "vitl_slice": vitl,
             "minvis_slice": minvis, "clip_slice": clip, "vps_slice": vps, "vss_slice": vss,
             "daq_slice": daq_online, "daq_offline_slice": daq_offline,
             "ov_slice": ov_online, "ov_offline_slice": ov_offline, **last, "train_slice": train,
             **stages}

    def by_path(kernel):
        return {name: r["launches"][kernel] for name, r in paths.items()}

    emit({"kernels": [{
        "name": "msdeform_fwd",
        "route": "cuda",
        "source": "dvis_plus_tpu_torch/csrc/msdeform_fwd.cu",
        "replaces": "dvis_plus_tpu/ops/msdeform_pallas.py:67",
        "launches": runs["exact"]["launches"]["msdeform_fwd"],
        "launches_by_path": by_path("msdeform_fwd"),
        "max_abs_err": max([f["max_abs_err"] for forms in b1.values() for f in forms]
                           + [f["max_abs_err"] for f in b1_shapes.values()]),
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
    }, {
        "name": "msdeform_bwd",
        "route": "cuda",
        "source": "dvis_plus_tpu_torch/csrc/msdeform_bwd.cu",
        "replaces": "dvis_plus_tpu/ops/msdeform_pallas.py:570",
        "launches": stages["minvis_train_slice"]["launches"]["msdeform_bwd"],
        "launches_by_path": by_path("msdeform_bwd"),
        "max_abs_err": max(v for f in b1b for v in f["max_abs_err"].values()),
        "ms": b1b_main["ms"],
        "plain_ms": b1b_main["plain_ms"],
        "bound_ms": b1b_main["bound_ms"],
        "bound_by": b1b_main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes it
        "by_shape": {f"{f['shape']}{'_clamped_r7' if f['radius'] else ''}"
                     f"{'' if f['offsets'] == 'uniform' else '_' + f['offsets'] + '_offsets'}":
                     {k: f[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "value_dtype", "direct_share")} for f in b1b},
    }]})
    emit({"phase": "wall", "seconds": time.perf_counter() - start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
