"""What a run refuses: a machine without the card, and JAX in its process."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from port_bench.bench import guards, registry


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["dvis_plus_tpu_torch", "dvis_plus_tpu_torch.models.meta", "jaxtyping", "numpy"]
    assert guards.forbidden_modules(mods) == []
    assert guards.forbidden_modules(mods + ["dvis_plus_tpu.core.zoo_convert"]) == ["dvis_plus_tpu"]
    assert guards.forbidden_modules(["jax.numpy", "jaxlib.xla_client", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]


def test_nothing_of_jax_after_a_run_on_the_cpu(tmp_path):
    """The driver, the program and the reference load no forbidden module
    (checked in a fresh process: this test process may hold others)."""
    code = (
        "import sys, pathlib; sys.path.insert(0, %r)\n"
        "from port_bench.tests import common\n"
        "from port_bench.drivers import eval_stream\n"
        "from port_bench.bench import guards\n"
        "r = eval_stream.run(common.ctx(pathlib.Path(%r)))\n"
        "print(guards.forbidden_modules(), r.correct)\n" % (registry.ROOT, str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_require_cuda_raises_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(guards.NoDevice):
        guards.require_cuda(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(guards.NoDevice):
        guards.require_cuda(4)


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, os.path.join(registry.BENCH, "run.py"), "--workload",
                          "vitl_offline_vspw.stream", "--seed", str(2**31 + 5), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=registry.ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
