"""``eval_stream``: one client reads a set of videos back to back through the
program's VSS eval loop, the way an eval or labelling job does (a closed loop).

Set-up: the program's model built on the card with the benchmark's weights
from the seed, and one untimed warm-up video. The video pool is written on a
checkout's first run before it; its seconds are kept apart (``pool_s``) and
not counted in ``setup_s``, since a user's videos are on disk already.

The window: the program's test loader
(``data.build.build_test_loader`` over the registered stream, the VSS mapper
reading the JPEG frames) feeds ``engine.inference.run_vss_inference``, whose
(T, H, W) class maps reach the benchmark's evaluator; no new video is handed
in once ``--seconds`` have passed but to complete a group of the mix's
``stop_every`` videos, and the one in flight finishes. The rate is every
completed video's frames over the time to the last completion.

The videos' lengths come from the mix's ``pairs``: every pair sums to the same
number of frames, the seed shuffles the pairs and the order within each, and
draws each video's pool video and first frame. After the window the videos
the seed picked for the check (the long video of one of the first two pairs
and the short one of the other) are compared with the plain reference
(``reference/check_vss.py``). What is captured of the model, its layer spans,
the reference and the operations of a video come from the adapter that the
configuration names (``adapters/``).
"""
from __future__ import annotations

import gc
import os
import random
import tempfile
import time
from types import SimpleNamespace
from typing import Any, Dict, List

import numpy as np
import torch

from port_bench.bench import pool, portcfg, trace as trace_mod, weights
from port_bench.bench.spans import PREFIX, Spans
from port_bench.reference import check_vss
from port_bench.work import counts, peaks

DATASET = "port_bench_stream"


def plan(mix: Dict[str, Any], seed: int, checked_only: bool = False) -> SimpleNamespace:
    """The stream a seed gives: the videos, the warm-up video, the indices of
    the checked videos and the order in which the loader reads them: every
    video, or (``checked_only``, the limits' calibration) the checked ones."""
    rng = random.Random(seed)
    p = mix["pool"]
    names = pool.video_names(p)
    pairs = [tuple(x) for x in mix["lengths"]["pairs"]]
    lengths: List[int] = []
    while len(lengths) < mix["plan_videos"]:
        cycle = list(pairs)
        rng.shuffle(cycle)
        for a, b in cycle:
            lengths += [a, b] if rng.random() < 0.5 else [b, a]
    videos = []
    for i, L in enumerate(lengths[: mix["plan_videos"]]):
        src = rng.randrange(len(names))
        first = rng.randrange(int(p["frames"]) - L + 1)
        videos.append({"name": names[src], "first": first, "length": L, "id": f"s{i:03d}"})
    warm = {"name": names[rng.randrange(len(names))], "first": 0,
            "length": int(mix["warmup_frames"]), "id": "warmup"}
    a, b = (0, 1) if rng.random() < 0.5 else (1, 0)
    long_of = lambda k: max((2 * k, 2 * k + 1), key=lambda i: videos[i]["length"])  # noqa: E731
    short_of = lambda k: min((2 * k, 2 * k + 1), key=lambda i: videos[i]["length"])  # noqa: E731
    checked = sorted({long_of(a), short_of(b)})
    return SimpleNamespace(videos=videos, warm=warm, checked=checked,
                           order=list(checked) if checked_only else list(range(len(videos))))


def records(root: str, videos: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    data = os.path.join(root, "VSPW_480p", "data")
    out = []
    for v in videos:
        files = [os.path.join(data, v["name"], "origin", f"{t:05d}.jpg")
                 for t in range(v["first"], v["first"] + v["length"])]
        out.append({"video_id": v["id"], "length": len(files), "file_names": files,
                    "sem_seg_file_names": [f[:-4] + ".png" for f in files]})
    return out


def sample_pixels(seed: int, n: int, count: int) -> torch.Tensor:
    """``count`` sorted flat indices into a grid of ``n`` pixels, drawn from ``seed``."""
    g = torch.Generator().manual_seed(int(seed) % (2**63))
    return torch.randperm(n, generator=g)[:count].sort().values


class Capture:
    """The program's outputs of the checked videos, taken where they are made:
    the adapter's (``append`` a window, ``put`` a video), the class logits and
    mask logits that reach ``semantic_inference``, and the class maps handed to
    the evaluator. Only references to the tensors are kept inside the window;
    nothing is copied or read back there."""

    def __init__(self, checked, n_pixels: int, seed: int):
        self.checked = set(checked)
        self.current = -1
        self.out: Dict[int, Dict[str, Any]] = {}
        self.n_pixels, self.seed = n_pixels, seed
        self.idx = None

    def _slot(self):
        return self.out.setdefault(self.current, {"lists": {}, "dims": {}, "one": {}}) \
            if self.current in self.checked else None

    def append(self, name: str, t: torch.Tensor, dim: int = 0) -> None:
        slot = self._slot()
        if slot is not None:
            slot["lists"].setdefault(name, []).append(t)
            slot["dims"][name] = dim

    def put(self, name: str, t) -> None:
        slot = self._slot()
        if slot is not None:
            slot["one"][name] = t

    def sample_index(self, n: int, device) -> torch.Tensor:
        if self.idx is None:
            self.idx = sample_pixels(self.seed, n, self.n_pixels)
        return self.idx.to(device)

    def semantic(self, mask_pred, aux):
        if self.current in self.checked:
            if aux is not None:
                self.put("aux_logits", aux)
            idx = self.sample_index(mask_pred.shape[-2] * mask_pred.shape[-1], mask_pred.device)
            self.append("mask_samples", mask_pred.flatten(2)[:, :, idx], dim=1)

    def results(self) -> Dict[int, Dict[str, torch.Tensor]]:
        res = {}
        for i, s in self.out.items():
            if "class_map" not in s["one"]:
                continue
            out = {k: torch.cat(v, dim=s["dims"][k]).float().cpu() for k, v in s["lists"].items()}
            out.update({k: v.float().cpu() for k, v in s["one"].items() if k != "class_map"})
            out["class_map"] = torch.from_numpy(np.ascontiguousarray(s["one"]["class_map"]))
            res[i] = out
        return res


class Evaluator:
    """Takes each video's class map as the VSS evaluators do, writes nothing,
    and notes the completion."""

    def __init__(self, on_done=None):
        self.on_done = on_done
        self.videos = 0

    def process(self, video_id, frame_names, sem_seg: np.ndarray) -> None:
        self.videos += 1
        if self.on_done is not None:
            self.on_done(video_id, sem_seg)


def _install_capture(model, cap: Capture, adapter):
    import dvis_plus_tpu_torch.engine.inference as inf

    undo_adapter = adapter.capture(model, cap)
    sem = inf.semantic_inference

    def semantic_inference(mask_cls, mask_pred, img_size, output_size, padded_size, aux_pred_cls=None):
        cap.semantic(mask_pred, aux_pred_cls)
        return sem(mask_cls, mask_pred, img_size=img_size, output_size=output_size,
                   padded_size=padded_size, aux_pred_cls=aux_pred_cls)

    inf.semantic_inference = semantic_inference

    def undo():
        undo_adapter()
        inf.semantic_inference = sem

    return undo


def _install_spans(model, spans: Spans, adapter) -> None:
    """The layer spans of the traced run (the adapter's), and the shapes the
    rooflines need. ``forward`` is the eval loop's forward of a video;
    ``post`` runs from its return to the evaluator's (the class maps on the
    card, their download, the evaluator)."""
    import dvis_plus_tpu_torch.engine.inference as inf
    import dvis_plus_tpu_torch.models.backbones.vit_adapter as vit_mod
    import dvis_plus_tpu_torch.models.segmenter.pixel_decoder as pd_mod

    forward = inf._forward

    def _forward(*args, **kwargs):
        spans.begin("forward")
        try:
            out = forward(*args, **kwargs)
        finally:
            spans.end("forward")
        spans.begin("post")  # ends in the evaluator
        return out

    inf._forward = _forward
    spans.on_remove(lambda: setattr(inf, "_forward", forward))
    adapter.spans(model, spans)

    def sampling_shape(value, spatial_shapes, loc, attn, *rest, **kw):
        B, Len, M, D = value.shape
        return ("sampling", B, Len, loc.shape[1], M, loc.shape[3], loc.shape[4], D,
                str(value.dtype).replace("torch.", ""), str(attn.dtype).replace("torch.", ""))

    for mod in (pd_mod, vit_mod):
        spans.function("msdeform", mod, "ms_deform_attn", shapes=sampling_shape)
    for name, m in model.named_modules():
        if type(m).__name__ == "MSDeformAttn":
            for proj in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
                lin = getattr(m, proj)
                spans.module("msdeform", lin, shapes=lambda args, lin=lin: (
                    "linear", args[0].numel() // args[0].shape[-1], lin.in_features, lin.out_features,
                    str(args[0].dtype).replace("torch.", "")))
        if type(m).__name__ == "Attention" and name.startswith("backbone.vit_module.blocks"):
            spans.module("vit_attention", m, shapes=lambda args, m=m: (
                "vit_attention", args[0].shape[0], args[0].shape[1], args[0].shape[2], m.num_heads,
                str(args[0].dtype).replace("torch.", "")))


def least_time_s(shapes: List[tuple]) -> float:
    """The least time of the recorded calls' work on an H100 (``work/``)."""
    total = 0.0
    for s in shapes:
        if s[0] == "linear":
            _, rows, k, n, dt = s
            f, b = counts.linear(rows, k, n, dt)
        elif s[0] == "sampling":
            _, B, Len, Lq, M, L, P, D, vdt, wdt = s
            f, b = counts.msdeform_sampling(B, Len, Lq, M, L, P, D, vdt, wdt)
            dt = vdt
        else:  # the trunk's attention block: qkv, attention, projection
            _, B, L, C, H, dt = s
            parts = [counts.linear(B * L, C, 3 * C, dt), counts.attention(B, H, L, L, C // H, dt),
                     counts.linear(B * L, C, C, dt)]
            total += sum(peaks.least_time(f, b, dt) for f, b in parts)
            continue
        total += peaks.least_time(f, b, dt)
    return total


def run(ctx) -> Dict[str, Any]:
    """ctx: SimpleNamespace(cell, cfg_file, adapter, mix, seed, seconds, trace,
    device, t_start, overrides=(), pools=..., cache=..., limits={...},
    plan=None (``plan(mix, seed)``), tamper=None, with_control=False).
    Returns the readings of the run."""
    from dvis_plus_tpu_torch.cli import build_model
    from dvis_plus_tpu_torch.data.build import build_test_loader
    from dvis_plus_tpu_torch.data.catalog import register_dataset
    from dvis_plus_tpu_torch.engine.inference import run_vss_inference

    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.pop("DVIS_OFFLINE_MF_BUDGET_GB", None)  # the configuration's budget holds
    cfg = portcfg.build(ctx.cfg_file, ctx.overrides)
    mix, adapter = ctx.mix, ctx.adapter
    t_pool = time.perf_counter()
    root = pool.ensure_pool(ctx.pools, mix["pool"])
    pool_s = time.perf_counter() - t_pool
    pl = ctx.plan or plan(mix, ctx.seed)
    recs = records(root, pl.videos)
    register_dataset(DATASET, lambda: [recs[i] for i in pl.order], evaluator_type="vss",
                     num_classes=cfg.model.num_classes)
    register_dataset(DATASET + "_warmup", lambda: records(root, [pl.warm]), evaluator_type="vss",
                     num_classes=cfg.model.num_classes)
    gains = ctx.cfg_file.get("init_gains", {})
    model = weights.build_on(lambda: build_model(cfg.model), dev, ctx.seed, gains)

    with torch.inference_mode():
        run_vss_inference(cfg, model, build_test_loader(cfg, DATASET + "_warmup",
                                                        dataset_type="video_semantic"), Evaluator())
    if ctx.trace and cuda:  # the profiler's first start is set-up too
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device=dev).add_(1)
    if ctx.tamper is not None:  # the CPU tests' faults, planted in the program under the capture
        ctx.tamper(model)
    cap = Capture(pl.checked, mix["check"]["mask_pixels"], ctx.seed)
    undo_capture = _install_capture(model, cap, adapter)
    spans = Spans(dev, enabled=bool(ctx.trace))
    if ctx.trace:
        _install_spans(model, spans, adapter)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start - pool_s

    state = SimpleNamespace(loader_s=0.0, handed=0, t_last=t0, done_frames=0, lengths=[],
                            prof=None, stretch=None, trace_path=None)
    prof = mix.get("profile", {"first": 1, "videos": 1})
    prof_first, prof_last = int(prof["first"]), int(prof["first"]) + int(prof["videos"]) - 1
    stop_every = int(mix.get("stop_every", 1))

    def finish_profile():
        if state.prof is None:
            return
        if cuda:
            torch.cuda.synchronize()
        spans.record_shapes = False
        state.stretch.__exit__(None, None, None)
        state.prof.__exit__(None, None, None)
        fd, state.trace_path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        state.prof.export_chrome_trace(state.trace_path)
        state.prof = None

    def on_done(video_id, sem):
        i = int(str(video_id)[1:])
        cap.current = i
        cap.put("class_map", sem)
        state.t_last = time.perf_counter()
        state.done_frames += int(sem.shape[0])
        state.lengths.append(int(sem.shape[0]))
        spans.end("post")
        if ctx.trace and i == prof_last:
            finish_profile()

    def stream():
        it = iter(build_test_loader(cfg, DATASET, dataset_type="video_semantic"))
        for k, i in enumerate(pl.order):
            # no new group of ``stop_every`` videos starts once the window's seconds are up
            if k % stop_every == 0 and time.perf_counter() - t0 >= ctx.seconds:
                return
            if ctx.trace and cuda and i == prof_first:
                state.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                                torch.profiler.ProfilerActivity.CUDA])
                state.prof.__enter__()
                state.stretch = torch.profiler.record_function(PREFIX + "stretch")
                state.stretch.__enter__()
                spans.record_shapes = True
            a = time.perf_counter()
            spans.begin("loader")
            sample = next(it, None)
            spans.end("loader")
            state.loader_s += time.perf_counter() - a
            if sample is None:
                return
            cap.current = i
            state.handed += 1
            yield sample

    evaluator = Evaluator(on_done)
    timings: Dict[str, float] = {}
    run_vss_inference(cfg, model, stream(), evaluator, timings=timings)
    if cuda:
        torch.cuda.synchronize()
    finish_profile()
    window_s = state.t_last - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    span_totals = spans.totals()
    spans.remove()
    undo_capture()
    reduced = {}
    if state.trace_path:
        reduced = trace_mod.reduce_trace(state.trace_path)
        os.remove(state.trace_path)

    H, W = int(mix["pool"]["height"]), int(mix["pool"]["width"])
    div = cfg.model.size_divisibility
    padded = (-(-H // div) * div, -(-W // div) * div)
    work_cache = os.path.join(ctx.cache, f"work-{ctx.cfg_file['name']}.json")
    done_flops = sum(adapter.video_flops(cfg.model, T, padded, (H, W), (H, W), cfg.test.window_size,
                                         work_cache) for T in state.lengths) if ctx.trace else None
    readings = SimpleNamespace(
        frames=state.done_frames, videos=evaluator.videos, handed=state.handed, window_s=window_s,
        setup_s=setup_s, pool_s=pool_s, peak_bytes=peak, loader_s=state.loader_s, timings=timings,
        spans=span_totals, stretch_shapes=dict(spans.shapes), trace=reduced, done_flops=done_flops,
        least_time_s=least_time_s, unit="frame", lengths=list(state.lengths))

    # the check, once the window has closed and the program's state is freed
    program = cap.results()
    del model, cap
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checked = [i for i in pl.checked if i in program]
    numbers = {}
    t_check = time.perf_counter()
    if checked:
        ns = portcfg.namespace(ctx.cfg_file, ctx.overrides)
        n_grid = (padded[0] // 4) * (padded[1] // 4)
        idx = sample_pixels(ctx.seed, n_grid, mix["check"]["mask_pixels"])
        vids = [recs[i] for i in checked]
        ref = lambda **kw: adapter.reference_outputs(ns, ctx.seed, gains, vids, idx, dev, **kw)  # noqa: E731
        cands = [{"program": program[i]["class_map"]} for i in checked]
        control = None
        if ctx.with_control:  # calibrate.py: the fp8 control as a candidate too
            control = ref(precision="fp8")
            for c, out in zip(cands, control):
                c["control"] = out["class_map"]
        refs = ref(candidates=cands)
        numbers = check_vss.worst(check_vss.compare(program[i], r) for i, r in zip(checked, refs))
        if control is not None:
            readings.control_numbers = check_vss.worst(
                check_vss.compare(c, r, "control") for c, r in zip(control, refs))
    readings.program = program
    readings.check_s = time.perf_counter() - t_check
    readings.numbers = numbers
    readings.checks = check_vss.judge(numbers, ctx.limits) if numbers else {}
    readings.correct = bool(checked) and check_vss.passed(readings.checks) and \
        evaluator.videos == state.handed
    readings.attempted, readings.failed = state.handed, state.handed - evaluator.videos
    readings.metrics = {"eval_fps": state.done_frames / window_s if window_s > 0 else 0.0,
                        "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
    return readings
