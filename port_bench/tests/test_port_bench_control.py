"""The check's control at a size a test run holds: the plain reference put in
the program's place, computed in fp8 (the precision below the configuration's
bf16), fails the cell's limits, while the program passes them. On the card at
the cell's own size the same readings come from ``calibrate.py``
(``PERF.md`` gives them and the limits set from them)."""
from __future__ import annotations

import pytest

from port_bench import calibrate
from port_bench.drivers import eval_stream
from port_bench.reference import check_vss
from port_bench.tests import common
from port_bench.tests.test_port_bench_faults import cell_limits


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 4000000001])
def test_control_fails_and_program_passes(tmp_path, seed):
    ctx = common.ctx(tmp_path, seed=seed, limits={},
                     plan=eval_stream.plan(common.tiny_mix(), seed, checked_only=True))
    out = calibrate.calibrate(ctx, control=True)
    limits = cell_limits()
    assert check_vss.passed(check_vss.judge(out["program"], limits)), out["program"]
    assert not check_vss.passed(check_vss.judge(out["control"], limits)), out["control"]
