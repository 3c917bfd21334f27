"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Every run is a fresh process: it loads, warms
up, measures for ``--seconds``, checks the program's outputs against the
plain reference, and prints one JSON object as the last line of standard
output (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, then ``pool_s``, the seconds of the
synthetic video pool's write, which only a checkout's first run makes and
``setup_s`` leaves out, and ``checks`` last: each compared number beside its
limit), and the same numbers as the last lines of standard error.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics. It exits non-zero and prints no result without the CUDA
cards the cell asks for, or when a module of JAX or of the JAX package is
loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench.bench import guards, registry  # noqa: E402


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def assemble(cell, readings, trace: bool, device: dict, root: str = registry.ROOT) -> dict:
    """The result line of a run from its traffic kind's readings."""
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.metrics_of(cell["name"], kind, root):
        if trace:
            value = registry.metric_reader(m["name"], root)(readings)
        else:
            value = readings.metrics.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(readings.correct), "attempted": int(readings.attempted),
           "failed": int(readings.failed), "metrics": metrics, "device": device}
    if trace and readings.trace:
        out["breakdown"] = {"device_ops": readings.trace["device_ops"],
                            "idle_gaps": readings.trace["idle_gaps"]}
    out["pool_s"] = readings.pool_s  # the pool's first write, kept out of ``setup_s``
    out["checks"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                     for k, v in readings.checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, cfg_entry, mix = registry.workload(args.workload)
    guards.require_cuda(int(cell["chips"]))
    cfg_file = registry.config_file(cfg_entry)
    driver = importlib.import_module(f"port_bench.drivers.{mix['kind']}")
    limits_path = os.path.join(registry.BENCH, "limits", f"{cell['name']}.json")
    with open(limits_path) as f:
        limits = json.load(f)["limits"]
    ctx = SimpleNamespace(cell=cell, cfg_file=cfg_file, adapter=registry.adapter(cfg_file), mix=mix,
                          seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device="cuda:0",
                          t_start=T_START, overrides=(), pools=registry.POOLS, cache=registry.CACHE,
                          limits=limits, plan=None, tamper=None, with_control=False)
    readings = driver.run(ctx)
    found = guards.forbidden_modules()
    if found:
        print(f"port_bench: forbidden modules loaded in the run's process: {found}", file=sys.stderr)
        return 1
    device = guards.device_info(int(cell["chips"]), readings.peak_bytes)
    if args.trace and readings.trace:
        device["busy_s"] = readings.trace["busy_s"]
        device["window_s"] = readings.trace["stretch_s"]
    out = assemble(cell, readings, bool(args.trace), device)
    print(f"port_bench: window {readings.window_s:.3f} s, {readings.attempted} attempted, "
          f"pool {readings.pool_s:.2f} s, check {readings.check_s:.1f} s, "
          f"checked {sorted(readings.program)}", file=sys.stderr)
    for k, v in sorted(readings.numbers.items()):
        if k not in out["checks"]:
            print(f"reading {k}: {v} (not compared)", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
