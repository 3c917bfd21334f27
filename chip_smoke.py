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
  ``configs/dvis/dvis_offline_swinl_ytvis19.yaml`` (kernels B1 and B2).

Run from a checkout of the repository:

    python3 chip_smoke.py

Each phase prints one JSON line. The last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed; any
failure raises (exit code != 0). It needs CUDA and exits non-zero without it.

Numerics: TF32 is off for matmuls and convolutions in every phase, so the
fp32 parts (the deformable encoder island, mask products) run in full fp32;
the timed slices run the configuration's ``compute_dtype`` (bfloat16).
"""
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
LEVELS = [(60, 80), (30, 40), (15, 20)]  # 480x640 input: strides 8, 16, 32
FRAMES, VIDEOS, H_IN, W_IN, H_OUT, W_OUT = 15, 2, 480, 640, 720, 960
KERNEL_TOL = 1e-5  # max |kernel - twin| / max |twin|, both accumulate in fp32
# B2 in bf16: p and the output round to bf16 on both sides after sums taken
# in different orders, so they may differ by one bf16 ulp of the output
KERNEL_TOL_BF16 = 1e-2
SLICE_TOL = 1e-3  # GPU (kernel, cuDNN) vs CPU (twin) fp32 path, small input
# B2 shapes of Swin-L (window 12, N = 144, Dh = 32) at 480x640 and 5 frames:
# stage 0 is 120x160 tokens, padded to 120x168 = 140 windows; stage 3 is
# 15x20, padded to 24x24 = 4 windows
SWIN_STAGES = [
    {"stage": 0, "B_": 5 * 140, "heads": 6, "map": (120, 168), "nW": 140},
    {"stage": 3, "B_": 5 * 4, "heads": 48, "map": (24, 24), "nW": 4},
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event-timed runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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

    t0 = time.perf_counter()
    path = _build.build()
    seconds = time.perf_counter() - t0
    _build.library()  # loads and binds every entry point
    emit({"phase": "build", "seconds": seconds, "library": os.path.relpath(path, REPO)})


def msdeform_inputs(dev, seed=SEED, BT=5, M=8, D=32, P=4):
    """Encoder-shaped inputs: queries are the level grids, offsets up to 10
    pixels, so some locations leave [0, 1] and some exceed the radius."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    Len = sum(h * w for h, w in LEVELS)
    L = len(LEVELS)
    refs = []
    for H, W in LEVELS:
        ry = (torch.arange(H) + 0.5) / H
        rx = (torch.arange(W) + 0.5) / W
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = torch.cat(refs)[None, :, None, None, None, :]
    norm = torch.tensor([[w, h] for h, w in LEVELS], dtype=torch.float32)[None, None, None, :, None]
    off = (torch.rand(BT, Len, M, L, P, 2, generator=g) * 2 - 1) * 10.0
    loc = (ref + off / norm).contiguous()
    attn = torch.rand(BT, Len, M, L * P, generator=g).softmax(-1).reshape(BT, Len, M, L, P)
    value = torch.randn(BT, Len, M, D, generator=g)
    return value.to(dev), loc.to(dev), attn.contiguous().to(dev)


def kernel_check(name, got_fn, want_fn, tol, iters=50, plain_iters=10):
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
    res["ms"] = cuda_ms(got_fn, iters)
    res["plain_ms"] = cuda_ms(want_fn, plain_iters)
    return res


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


def phase_kernels(dev):
    """B1 against its twin at the R50 slice's shapes, both forms; B2 at the
    Swin-L stages' shapes, with and without the shift mask; fp32 and bf16."""
    import torch

    from dvis_plus_tpu_torch.models.backbones.swin import shift_mask
    from dvis_plus_tpu_torch.ops import msdeform, swin_window_attn

    value, loc, attn = msdeform_inputs(dev)
    b1 = []
    for radius in (None, 7):
        for dtype in (torch.float32, torch.bfloat16):
            v = value.to(dtype)
            res = kernel_check(
                "msdeform_fwd",
                lambda: msdeform.ms_deform_attn(v, LEVELS, loc, attn, radius=radius),
                lambda: msdeform.ms_deform_attn_torch(v, LEVELS, loc, attn, radius=radius),
                KERNEL_TOL,
            )
            b1.append({"radius": radius, "value_dtype": str(dtype).split(".")[1], **res})
    emit({"phase": "kernels", "kernel": "msdeform_fwd",
          "shapes": {"value": list(value.shape), "loc": list(loc.shape)}, "forms": b1})

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
                b2.append({"stage": st["stage"], "B_": B_, "C": C, "heads": H,
                           "nW": st["nW"] if masked else 0, "dtype": str(dtype).split(".")[1],
                           **res})
    emit({"phase": "kernels", "kernel": "swin_window_attn_fwd", "N": 144, "forms": b2})
    return b1, b2


def synthetic_videos(n, T, H, W, Ho, Wo, seed):
    rng = np.random.RandomState(seed)
    for vid in range(n):
        yield {
            "images": rng.randn(T, H, W, 3).astype(np.float32),
            "image_size": np.asarray([H, W], np.int32),
            "height": Ho, "width": Wo, "video_id": vid + 1,
        }


def build_model(cfg, dev):
    import torch

    from dvis_plus_tpu_torch.models.meta.dvis_offline import DVISOffline
    from dvis_plus_tpu_torch.models.meta.dvis_online import DVISOnline

    torch.manual_seed(SEED)
    arch = DVISOffline if cfg.model.meta_architecture == "dvis_offline" else DVISOnline
    return arch(cfg.model).to(dev).eval()


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


def timed_slice(cfg, dev):
    """2 synthetic videos x 15 frames at 480x640 (output 720x960) through
    ``run_vis_inference`` after one untimed warm-up video; the kernels'
    launch counts are read from the timed run alone."""
    import torch

    from dvis_plus_tpu_torch.engine.inference import run_vis_inference
    from dvis_plus_tpu_torch.evaluation.evaluators import YTVISEvaluator
    from dvis_plus_tpu_torch.ops import msdeform, swin_window_attn

    model = build_model(cfg, dev)
    with tempfile.TemporaryDirectory() as tmp:
        # warm-up video (cuDNN / cuBLAS autotuning, allocator), not timed
        run_vis_inference(cfg, model, synthetic_videos(1, 5, H_IN, W_IN, H_OUT, W_OUT, 99),
                          YTVISEvaluator("warmup", tmp))
        evaluator = YTVISEvaluator("synthetic", tmp)
        timings = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        msdeform.reset_launches()
        swin_window_attn.reset_launches()
        t0 = time.perf_counter()
        run_vis_inference(cfg, model,
                          synthetic_videos(VIDEOS, FRAMES, H_IN, W_IN, H_OUT, W_OUT, SEED),
                          evaluator, timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"msdeform_fwd": msdeform.launches,
                    "swin_window_attn_fwd": swin_window_attn.launches}
        rows = evaluator.predictions
        size = os.path.getsize(evaluator.write_results())
    topk = cfg.test.max_num
    videos = sorted({r["video_id"] for r in rows})
    rows_ok = (
        len(rows) == VIDEOS * topk
        and videos == list(range(1, VIDEOS + 1))
        and all(0.0 <= r["score"] <= 1.0 for r in rows)
        and all(1 <= r["category_id"] <= cfg.model.num_classes for r in rows)
        and all(len(r["segmentations"]) == FRAMES for r in rows)
        and all(s is None or s["size"] == [H_OUT, W_OUT] for r in rows for s in r["segmentations"])
    )
    res = {"compute_dtype": cfg.model.compute_dtype, "tf32": False, "videos": VIDEOS,
           "frames": FRAMES, "input": [H_IN, W_IN], "window": cfg.test.window_size,
           "wall_s": wall, "fps": VIDEOS * FRAMES / wall,
           "model_fps": VIDEOS * FRAMES / timings["model_s"], "post_s": timings["post_s"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "rows": len(rows),
           "results_json_bytes": size, "launches": launches}
    return res, rows_ok


def phase_slice(dev, impl):
    """Full-width R50 DVIS++ online over 2 videos x 15 frames at 480x640."""
    from dvis_plus_tpu_torch.config import dvis_online_r50_ytvis19

    cfg = dvis_online_r50_ytvis19()
    cfg.model.pixel_decoder.msdeform_impl = impl
    res, rows_ok = timed_slice(cfg, dev)
    windows = VIDEOS * -(-FRAMES // cfg.test.window_size)
    expect = {"msdeform_fwd": cfg.model.pixel_decoder.transformer_enc_layers * windows,
              "swin_window_attn_fwd": 0}
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

    cfg = dvis_offline_swinl_ytvis19()
    res, rows_ok = timed_slice(cfg, dev)
    windows = VIDEOS * -(-FRAMES // cfg.test.window_size)
    expect = {"msdeform_fwd": cfg.model.pixel_decoder.transformer_enc_layers * windows,
              "swin_window_attn_fwd": sum(cfg.model.backbone.swin_depths) * windows}
    res = {"phase": "swinl_slice", "backbone": cfg.model.backbone.name,
           "meta_architecture": cfg.model.meta_architecture, **res, "expected_launches": expect}
    emit(res)
    if not (rows_ok and res["launches"] == expect):
        raise AssertionError(f"Swin-L slice check failed: {res}")
    return res


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
    b1, b2 = phase_kernels(dev)
    phase_slice_parity(dev)
    runs = {impl: phase_slice(dev, impl) for impl in ("exact", "pallas_local")}
    phase_host_syncs(dev)
    phase_swinl_slice_parity(dev)
    swinl = phase_swinl_slice(dev)

    # the timed forms: B1 exact fp32 (R50 encoder shapes); B2 Swin-L stage 0
    # with the shift mask in bf16, the serving dtype
    b1_main = next(f for f in b1 if f["radius"] is None and f["value_dtype"] == "float32")
    b2_main = next(f for f in b2 if f["stage"] == 0 and f["nW"] and f["dtype"] == "bfloat16")
    emit({"kernels": [{
        "name": "msdeform_fwd",
        "route": "cuda",
        "source": "dvis_plus_tpu_torch/csrc/msdeform_fwd.cu",
        "replaces": "dvis_plus_tpu/ops/msdeform_pallas.py:67",
        "launches": runs["exact"]["launches"]["msdeform_fwd"],
        "max_abs_err": max(f["max_abs_err"] for f in b1),
        "ms": b1_main["ms"],
        "plain_ms": b1_main["plain_ms"],
    }, {
        "name": "swin_window_attn_fwd",
        "route": "cuda",
        "source": "dvis_plus_tpu_torch/csrc/swin_window_attn_fwd.cu",
        "replaces": "dvis_plus_tpu/ops/swin_window_attn.py:60",
        "launches": swinl["launches"]["swin_window_attn_fwd"],
        "max_abs_err": max(f["max_abs_err"] for f in b2),
        "ms": b2_main["ms"],
        "plain_ms": b2_main["plain_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
