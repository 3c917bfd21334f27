"""Finds a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, the adapter of its model family that the configuration
names (``adapters/<reference>.py``), its traffic mix (``traffic/<mix>.json``)
and its per-layer metrics' readers (``metrics/<metric>.py``). A later cell
brings new files and entries; nothing here changes."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # port_bench/
ROOT = os.path.dirname(BENCH)  # the checkout
CACHE = os.path.join(BENCH, ".cache")  # work counts and traces of this checkout
POOLS = os.path.join(BENCH, ".pool")  # synthetic video pools, written on first use


def load_benchmark(root: str = ROOT) -> Dict[str, Any]:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    with open(path) as f:
        return json.load(f)


def workload(name: str, root: str = ROOT) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """(cell, configuration entry, traffic mix) of the cell ``name``."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell, configs[cell["config"]], traffic(cell["traffic"], root)


def config_file(entry: Dict[str, Any], root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic(name: str, root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, os.path.relpath(BENCH, ROOT), "traffic", f"{name}.json")) as f:
        mix = json.load(f)
    mix["name"] = name
    return mix


def metrics_of(cell: str, kind: str, root: str = ROOT) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``cell`` reports:
    those listing it under ``workloads``, and those without the key."""
    return [m for m in load_benchmark(root)[kind] if cell in m.get("workloads", [cell])]


def _load(folder: str, name: str, root: str):
    path = os.path.join(root, os.path.relpath(BENCH, ROOT), folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_{folder}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def adapter(cfg_file: Dict[str, Any], root: str = ROOT):
    """The module ``adapters/<name>.py`` that the configuration file names
    under ``reference``."""
    return _load("adapters", cfg_file["reference"], root)


def metric_reader(name: str, root: str = ROOT) -> Callable[[Any], Optional[float]]:
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    return _load("metrics", name, root).read
