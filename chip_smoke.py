#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``dvis_plus_tpu_torch/csrc``, holds
each kernel against its plain PyTorch twin at the shapes the main path gives
it, then drives the main path -- DVIS++ online VIS inference at the full
width of ``configs/dvis/dvis_online_r50_ytvis19.yaml`` with seeded random
weights -- through ``engine.inference.run_vis_inference`` and checks that it
went through the kernels. Run from a checkout of the repository:

    python3 chip_smoke.py

Each phase prints one JSON line. The last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed; any
failure raises (exit code != 0). It needs CUDA and exits non-zero without it.

Numerics: TF32 is off for matmuls and convolutions in every phase, so the
fp32 parts (the deformable encoder island, mask products) run in full fp32;
the timed slice runs the configuration's ``compute_dtype`` (bfloat16).
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
SLICE_TOL = 1e-3  # GPU (kernel, cuDNN) vs CPU (twin) fp32 path, small input


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


def phase_kernels(dev):
    """B1 against its twin at the slice's shapes, both forms, fp32 and bf16."""
    import torch

    from dvis_plus_tpu_torch.ops import msdeform

    value, loc, attn = msdeform_inputs(dev)
    forms = []
    for radius in (None, 7):
        for dtype in (torch.float32, torch.bfloat16):
            v = value.to(dtype)
            got = msdeform.ms_deform_attn(v, LEVELS, loc, attn, radius=radius)
            torch.cuda.synchronize()
            want = msdeform.ms_deform_attn_torch(v, LEVELS, loc, attn, radius=radius)
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            ms = cuda_ms(lambda: msdeform.ms_deform_attn(v, LEVELS, loc, attn, radius=radius), 50)
            plain = cuda_ms(lambda: msdeform.ms_deform_attn_torch(v, LEVELS, loc, attn, radius=radius), 10)
            forms.append({"radius": radius, "value_dtype": str(dtype).split(".")[1],
                          "max_abs_err": err, "rel_err": rel, "tol": KERNEL_TOL,
                          "ms": ms, "plain_ms": plain})
            if not (np.isfinite(rel) and rel <= KERNEL_TOL):
                emit({"phase": "kernels", "failed": forms[-1]})
                raise AssertionError(f"msdeform kernel disagrees with its twin: {forms[-1]}")
    emit({"phase": "kernels", "shapes": {"value": list(value.shape), "loc": list(loc.shape)},
          "forms": forms})
    return forms


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

    from dvis_plus_tpu_torch.models.meta.dvis_online import DVISOnline

    torch.manual_seed(SEED)
    return DVISOnline(cfg.model).to(dev).eval()


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


def phase_slice(dev, impl):
    """Full-width R50 DVIS++ online over 2 videos x 15 frames at 480x640."""
    import torch

    from dvis_plus_tpu_torch.config import dvis_online_r50_ytvis19
    from dvis_plus_tpu_torch.engine.inference import run_vis_inference
    from dvis_plus_tpu_torch.evaluation.evaluators import YTVISEvaluator
    from dvis_plus_tpu_torch.ops import msdeform

    cfg = dvis_online_r50_ytvis19()
    cfg.model.pixel_decoder.msdeform_impl = impl
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
        t0 = time.perf_counter()
        run_vis_inference(cfg, model,
                          synthetic_videos(VIDEOS, FRAMES, H_IN, W_IN, H_OUT, W_OUT, SEED),
                          evaluator, timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = msdeform.launches
        rows = evaluator.predictions
        size = os.path.getsize(evaluator.write_results())
    windows = VIDEOS * -(-FRAMES // cfg.test.window_size)
    expect = cfg.model.pixel_decoder.transformer_enc_layers * windows
    topk = cfg.test.max_num
    videos = sorted({r["video_id"] for r in rows})
    ok = (
        launches == expect
        and len(rows) == VIDEOS * topk
        and videos == list(range(1, VIDEOS + 1))
        and all(0.0 <= r["score"] <= 1.0 for r in rows)
        and all(1 <= r["category_id"] <= cfg.model.num_classes for r in rows)
        and all(len(r["segmentations"]) == FRAMES for r in rows)
        and all(s is None or s["size"] == [H_OUT, W_OUT] for r in rows for s in r["segmentations"])
    )
    res = {"phase": "slice", "msdeform_impl": impl, "compute_dtype": cfg.model.compute_dtype,
           "tf32": False, "videos": VIDEOS, "frames": FRAMES, "input": [H_IN, W_IN],
           "window": cfg.test.window_size, "wall_s": wall, "fps": VIDEOS * FRAMES / wall,
           "model_fps": VIDEOS * FRAMES / timings["model_s"], "post_s": timings["post_s"],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "rows": len(rows),
           "results_json_bytes": size, "msdeform_launches": launches,
           "expected_launches": expect}
    emit(res)
    if not ok:
        raise AssertionError(f"slice check failed ({impl}): {res}")
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
    forms = phase_kernels(dev)
    phase_slice_parity(dev)
    runs = {impl: phase_slice(dev, impl) for impl in ("exact", "pallas_local")}
    phase_host_syncs(dev)

    main_form = next(f for f in forms if f["radius"] is None and f["value_dtype"] == "float32")
    emit({"kernels": [{
        "name": "msdeform_fwd",
        "route": "cuda",
        "source": "dvis_plus_tpu_torch/csrc/msdeform_fwd.cu",
        "replaces": "dvis_plus_tpu/ops/msdeform_pallas.py:67",
        "launches": runs["exact"]["msdeform_launches"],
        "max_abs_err": max(f["max_abs_err"] for f in forms),
        "ms": main_form["ms"],
        "plain_ms": main_form["plain_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
