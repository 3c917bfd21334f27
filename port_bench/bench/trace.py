"""The profiled stretch of a traced run, reduced to what the per-layer metrics read.

``torch.profiler`` (CPU and CUDA activities) records a stretch of whole units
(videos or steps) inside the traced window, marked by the range
``pb:stretch``. Its Chrome trace is read back and reduced to:

- ``stretch_s``: the stretch's length on the host clock;
- ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran on the device, inside the stretch (overlapping kernels count
  once);
- ``range_device_s``: for each benchmark range (``pb:<name>``), the device
  time of the kernels whose launch the host made inside it (a kernel counts
  for every benchmark range it was launched in);
- ``device_ops``: the ten device operations with the most time, by name;
- ``idle_gaps``: the device's idle time inside the stretch by what the host
  was doing in each gap (the innermost benchmark range open at the gap's
  midpoint on the thread that launched the most work, or ``none``), summed
  by range, the ten largest.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Any, Dict, List, Tuple

from port_bench.bench.spans import PREFIX

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _load(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Total length covered by ``intervals`` (start, end), overlaps once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(a, b) for a, b in out]


def reduce_events(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Times in the trace are microseconds; the result is in seconds."""
    ranges = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith(PREFIX)]
    stretch = [e for e in ranges if e["name"] == PREFIX + "stretch"]
    if not stretch:
        return {}
    s0 = min(e["ts"] for e in stretch)
    s1 = max(e["ts"] + e["dur"] for e in stretch)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] < s1 and e["ts"] + e["dur"] > s0]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    clipped = [(max(e["ts"], s0), min(e["ts"] + e["dur"], s1)) for e in dev]
    busy = union_length(clipped)

    # ranges by thread, for attributing launches and labelling gaps
    by_tid: Dict[Any, List[Dict[str, Any]]] = defaultdict(list)
    for e in ranges:
        if e["name"] != PREFIX + "stretch":
            by_tid[(e.get("pid"), e.get("tid"))].append(e)
    range_dev = defaultdict(float)
    launch_count = defaultdict(int)
    for e in dev:
        la = launches.get(e.get("args", {}).get("correlation"))
        if la is None:
            continue
        key = (la.get("pid"), la.get("tid"))
        launch_count[key] += 1
        names = {r["name"][len(PREFIX):] for r in by_tid.get(key, ())
                 if r["ts"] <= la["ts"] <= r["ts"] + r["dur"]}
        for n in names:
            range_dev[n] += min(e["ts"] + e["dur"], s1) - max(e["ts"], s0)

    ops = defaultdict(float)
    for e, (a, b) in zip(dev, clipped):
        ops[e["name"]] += b - a
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]

    main = max(launch_count, key=launch_count.get) if launch_count else None
    main_ranges = sorted(by_tid.get(main, []), key=lambda r: r["ts"])
    starts = [r["ts"] for r in main_ranges]
    gaps = defaultdict(float)
    edge = s0
    for a, b in _merged(clipped) + [(s1, s1)]:
        if a > edge:
            # the innermost (latest-starting) main-thread range open at the gap's midpoint
            mid, label = 0.5 * (edge + a), "none"
            for r in reversed(main_ranges[: bisect.bisect_right(starts, mid)]):
                if r["ts"] <= mid <= r["ts"] + r["dur"]:
                    label = r["name"][len(PREFIX):]
                    break
            gaps[label] += a - edge
        edge = max(edge, b)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    us = 1e-6
    return {
        "stretch_s": (s1 - s0) * us,
        "busy_s": busy * us,
        "range_device_s": {k: v * us for k, v in range_dev.items()},
        "device_ops": [[k, v * us] for k, v in device_ops],
        "idle_gaps": [[k, v * us] for k, v in idle],
    }


def reduce_trace(path: str) -> Dict[str, Any]:
    return reduce_events(_load(path))
