"""The reader of the program's own download seconds: from the readings, in
the result line of traced runs only, and from the driver's run on the CPU;
a program whose loop keeps no ``download_s`` gives no reading."""
from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from port_bench import run
from port_bench.bench import registry
from port_bench.drivers import eval_stream
from port_bench.tests import common

NAME = "download_ms_per_frame.eval"


def _readings(**kw):
    base = dict(correct=True, attempted=3, failed=0, frames=10, unit="frame", loader_s=0.5,
                timings={"model_s": 1.0, "post_s": 0.2, "download_s": 0.02, "png_s": 0.1},
                spans={}, trace={}, done_flops=None, window_s=2.0, pool_s=0.0,
                metrics={"eval_fps": 5.0, "peak_mem_gib": 1.5, "setup_s": 3.0},
                checks={"map_frame_mismatch": {"value": 0.01, "limit": 0.1}})
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("kw, want", [
    ({}, 2.0),
    ({"timings": {"post_s": 0.2}}, None),  # a loop without the span's key
    ({"frames": 0}, None),
    ({"unit": "step"}, None),
])
def test_the_reader(kw, want):
    got = registry.metric_reader(NAME)(_readings(**kw))
    assert got == (want if want is None else pytest.approx(want))


def test_assemble_reports_it_in_traced_runs_only():
    cell = {"name": common.CELL}
    plain = run.assemble(cell, _readings(), False, {"platform": "gpu"})
    assert NAME not in plain["metrics"]
    traced = run.assemble(cell, _readings(), True, {"platform": "gpu"})
    assert traced["metrics"][NAME] == {"value": pytest.approx(2.0), "unit": "ms/frame"}
    bare = run.assemble(cell, _readings(timings={"post_s": 0.2}), True, {"platform": "gpu"})
    assert NAME not in bare["metrics"]


def test_the_driver_reads_the_programs_download(tmp_path):
    r = eval_stream.run(common.ctx(tmp_path, trace=True, overrides=("test.offline_mf_budget_gb=1e-7",),
                                   limits={"map_frame_mismatch": 1.0}))
    t = r.timings
    assert 0 < t["download_s"] + t["png_s"] <= t["post_s"]
    v = registry.metric_reader(NAME)(r)
    assert v is not None and math.isfinite(v) and v > 0
    assert v == pytest.approx(1e3 * t["download_s"] / r.frames)
