"""Readings the check's limits are set from, on the card at a cell's own size.

    python3 port_bench/calibrate.py --workload <cell> --seeds <n> ... [--control-seeds <n> ...]

For every seed, in one process: the program over the videos a run with that
seed checks (the same videos, the same eval loop and model as the timed
path; the model's state does not carry from one video to the next), the
plain reference in fp32 over them, and the check's numbers. For every control
seed also the control: the reference in the program's place, computed in
fp8 (every linear and convolution layer's weight and input rounded through
float8 e4m3, ``reference/layers.py``), held against the same fp32 reference.
One JSON line a seed on standard output. The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench.bench import guards, registry  # noqa: E402


def calibrate(ctx, control: bool):
    """One seed's readings: ``program`` (and ``control``) numbers."""
    driver = importlib.import_module(f"port_bench.drivers.{ctx.mix['kind']}")
    ctx.with_control = control
    t = time.perf_counter()
    r = driver.run(ctx)
    out = {"seed": ctx.seed, "videos": sorted(r.program), "lengths": r.lengths,
           "program": r.numbers, "seconds": time.perf_counter() - t, "check_s": r.check_s}
    if control:
        out["control"] = r.control_numbers
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell, cfg_entry, mix = registry.workload(args.workload)
    guards.require_cuda(int(cell["chips"]))
    cfg_file = registry.config_file(cfg_entry)
    driver = importlib.import_module(f"port_bench.drivers.{mix['kind']}")
    for seed in list(dict.fromkeys(args.seeds + args.control_seeds)):
        ctx = SimpleNamespace(cell=cell, cfg_file=cfg_file, adapter=registry.adapter(cfg_file), mix=mix,
                              seed=seed, seconds=math.inf, trace=False, device="cuda:0",
                              t_start=time.perf_counter(), overrides=(), pools=registry.POOLS,
                              cache=registry.CACHE, limits={}, tamper=None, with_control=False,
                              plan=driver.plan(mix, seed, checked_only=True))
        print(json.dumps(calibrate(ctx, seed in args.control_seeds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
