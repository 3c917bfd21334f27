"""The harness finds its pieces by name, and BENCHMARK.json keeps to its form."""
from __future__ import annotations

import json
import os
import re
import shutil
from types import SimpleNamespace

import pytest

from port_bench import run
from port_bench.bench import registry, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = registry.load_benchmark()


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                           "per_layer"]
    assert BENCH["paths"] == ["port_bench"] and 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(registry.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/") and os.path.exists(os.path.join(registry.ROOT, c["file"]))
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            reported = {e["name"] for e in registry.metrics_of(cell, "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in registry.metrics_of(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_of(w["name"], "per_layer")


def test_every_piece_is_a_file_found_by_name():
    for w in BENCH["workloads"]:
        cell, entry, mix = registry.workload(w["name"])
        assert os.path.exists(os.path.join(registry.BENCH, "drivers", f"{mix['kind']}.py"))
        assert registry.config_file(entry)["config"]["model"]
        assert os.path.exists(os.path.join(registry.BENCH, "limits", f"{w['name']}.json"))
    for m in BENCH["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))


def test_new_pieces_are_found_by_name_in_a_copy(tmp_path):
    """A later change adds a configuration, a traffic mix, a metric and a cell
    as new files and entries: the harness finds them without an edit."""
    root = tmp_path / "checkout"
    shutil.copytree(registry.BENCH, root / "port_bench", ignore=shutil.ignore_patterns(".pool", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.load(open(os.path.join(registry.ROOT, bench["configs"][0]["file"])))
    cfg["name"] = "copy_config"
    json.dump(cfg, open(root / "port_bench" / "configs" / "copy_config.json", "w"))
    mix = registry.traffic(bench["workloads"][0]["traffic"])
    mix["warmup_frames"] = 3
    json.dump(mix, open(root / "port_bench" / "traffic" / "copy_mix.json", "w"))
    (root / "port_bench" / "metrics" / "copy_metric.py").write_text(
        "def read(run):\n    return 2.0 * run.frames\n")
    bench["configs"].append({**bench["configs"][0], "name": "copy_config",
                             "file": "port_bench/configs/copy_config.json"})
    bench["workloads"].append({"name": "copy.cell", "config": "copy_config", "traffic": "copy_mix",
                               "chips": 1, "why": "a copy"})
    bench["per_layer"].append({"name": "copy_metric", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "data", "moves": "setup_s",
                               "workloads": ["copy.cell"]})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    cell, entry, found_mix = registry.workload("copy.cell", root=str(root))
    assert registry.config_file(entry, root=str(root))["name"] == "copy_config"
    assert found_mix["warmup_frames"] == 3 and found_mix["name"] == "copy_mix"
    assert registry.metric_reader("copy_metric", root=str(root))(SimpleNamespace(frames=4)) == 8.0
    assert [m["name"] for m in registry.metrics_of("copy.cell", "per_layer", root=str(root))] == ["copy_metric"]


TOY_ADAPTER = """
import torch


def capture(model, cap):
    hook = lambda _m, _a, out: cap.append("tracker_logits", out[0]["pred_logits"][0])
    return model.tracker.register_forward_hook(hook).remove


def spans(model, spans):
    spans.module("tracker", model.tracker)


def reference_outputs(ns, seed, gains, videos, sample_idx, device, precision="fp32", candidates=None):
    # a stand-in with no model: it returns the program's own class maps
    return [{"class_map": c["program"]} for c in candidates]


def video_flops(mcfg, T, padded, image_size, output_size, window, cache_path):
    return float(T)
"""


def test_a_new_adapter_is_found_and_driven_in_a_copy(tmp_path):
    """A configuration of another model family (DVIS++ online: no refiner)
    names an adapter added as a new file in a copy; the driver captures,
    spans and checks through it, with no existing file edited."""
    from port_bench.drivers import eval_stream
    from port_bench.tests import common

    root = tmp_path / "checkout"
    shutil.copytree(registry.BENCH, root / "port_bench",
                    ignore=shutil.ignore_patterns(".pool", ".cache"))
    (root / "port_bench" / "adapters" / "toy_online.py").write_text(TOY_ADAPTER)
    cfg = json.load(open(os.path.join(registry.ROOT, BENCH["configs"][0]["file"])))
    cfg.update(name="toy_online", reference="toy_online")
    cfg["config"]["model"]["meta_architecture"] = "dvis_online"
    adapter = registry.adapter(cfg, root=str(root))
    assert adapter.__file__ == str(root / "port_bench" / "adapters" / "toy_online.py")
    ctx = common.ctx(tmp_path, trace=True, limits={"map_frame_mismatch": 0.0})
    ctx.cfg_file, ctx.adapter = cfg, adapter
    r = eval_stream.run(ctx)
    assert r.correct and r.failed == 0, r.checks
    assert r.spans["tracker"]["calls"] > 0 and "refiner" not in r.spans
    checked = eval_stream.plan(ctx.mix, ctx.seed).checked
    assert sorted(r.program) == checked
    for i in checked:
        assert set(r.program[i]) == {"tracker_logits", "mask_samples", "class_map"}
    assert r.done_flops == sum(r.lengths)


def _readings(**kw):
    base = dict(correct=True, attempted=3, failed=0, frames=10, unit="frame", loader_s=0.5,
                timings={"post_s": 0.2}, spans={}, trace={}, done_flops=None, window_s=2.0, pool_s=0.0,
                metrics={"eval_fps": 5.0, "peak_mem_gib": 1.5, "setup_s": 3.0},
                checks={"map_frame_mismatch": {"value": 0.01, "limit": 0.1}})
    base.update(kw)
    return SimpleNamespace(**base)


def test_result_line_shape():
    cell = {"name": "vitl_offline_vspw.stream"}
    out = run.assemble(cell, _readings(), False, {"platform": "gpu"})
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "pool_s", "checks"]
    assert set(out["metrics"]) == {"eval_fps", "peak_mem_gib", "setup_s"}
    traced = run.assemble(cell, _readings(trace={"device_ops": [["k", 1.0]], "idle_gaps": [["loader", 0.5]]}),
                          True, {"platform": "gpu"})
    assert list(traced)[-3:] == ["breakdown", "pool_s", "checks"]
    # readers that find nothing to read leave their metric out
    assert set(traced["metrics"]) == {"loader_ms_per_frame.eval", "post_ms_per_frame.eval"}
    assert traced["metrics"]["loader_ms_per_frame.eval"] == {"value": 50.0, "unit": "ms/frame"}


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1, "args": args}


def test_trace_reduction():
    events = [
        _ev("user_annotation", "pb:stretch", 0, 100),
        _ev("user_annotation", "pb:loader", 0, 30),
        _ev("user_annotation", "pb:backbone", 30, 40),
        _ev("cuda_runtime", "cudaLaunchKernel", 31, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 32, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 75, 1, correlation=3),
        {**_ev("kernel", "a", 40, 20, correlation=1), "tid": 7},
        {**_ev("kernel", "b", 50, 20, correlation=2), "tid": 8},
        {**_ev("kernel", "a", 80, 10, correlation=3), "tid": 7},
    ]
    r = trace.reduce_events(events)
    assert r["stretch_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(40e-6)  # [40, 70) and [80, 90), the overlap once
    assert r["range_device_s"] == {"backbone": pytest.approx(40e-6)}
    assert r["device_ops"][0] == ["a", pytest.approx(30e-6)]
    gaps = dict(r["idle_gaps"])
    assert gaps["loader"] == pytest.approx(40e-6) and gaps["none"] == pytest.approx(20e-6)
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
