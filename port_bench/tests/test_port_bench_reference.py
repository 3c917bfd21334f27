"""The plain reference held to the benchmarked package at tiny widths on the CPU."""
from __future__ import annotations

import pytest
import torch

from port_bench.bench import portcfg, registry, weights
from port_bench.drivers import eval_stream
from port_bench.reference import deform, dvis as ref_dvis, layers, tracker as ref_tracker
from port_bench.reference.auction import auction_lap as ref_auction
from port_bench.tests import common


def _port_model():
    from dvis_plus_tpu_torch.cli import build_model

    _, entry, _ = registry.workload(common.CELL)
    cfg = portcfg.build(registry.config_file(entry), common.TINY)
    return build_model(cfg.model), portcfg.namespace(registry.config_file(entry), common.TINY)


def test_key_spaces_match():
    port, ns = _port_model()
    ref = ref_dvis.DVISOfflineReference(ns.model)
    assert weights.key_space(port) == weights.key_space(ref)


def test_weights_fill_every_tensor_the_same_way():
    port, ns = _port_model()
    ref = ref_dvis.DVISOfflineReference(ns.model)
    weights.fill_(port, 123, {"class_embed": 4.0})
    weights.fill_(ref, 123, {"class_embed": 4.0})
    a, b = dict(weights.tensors(port)), dict(weights.tensors(ref))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    rv = [t for k, t in a.items() if k.endswith("running_var")]
    assert rv and all(bool((t > 0).all()) for t in rv)


def test_build_on_meta_leaves_nothing_on_meta():
    port = weights.build_on(lambda: _port_model()[0], "cpu", 5)
    assert all(t.device.type == "cpu" for _, t in weights.tensors(port))


@pytest.mark.parametrize("seed", [1, 2**31 + 17])
@pytest.mark.parametrize("budget", [None, "test.offline_mf_budget_gb=1e-7"])
def test_reference_equals_program_in_fp32(tmp_path, seed, budget):
    """Both halves of the eval loop: masks kept on the device, and paged to
    host fp16 beyond the budget (which rounds the mask logits)."""
    ctx = common.ctx(tmp_path, seed=seed, overrides=(budget,) if budget else ())
    r = eval_stream.run(ctx)
    assert sorted(r.program) == r_checked(ctx) and r.failed == 0
    for k, v in r.numbers.items():
        tol = 1e-3 if (budget and (k == "mask_samples" or k.startswith("map_"))) else 1e-5
        assert v <= tol, (k, v)


def r_checked(ctx):
    return sorted(eval_stream.plan(ctx.mix, ctx.seed).checked)


def test_plain_deformable_attention_equals_the_package_twin():
    from dvis_plus_tpu_torch.ops.msdeform import ms_deform_attn_torch

    g = torch.Generator().manual_seed(0)
    shapes = [(6, 8), (3, 4)]
    value = torch.randn(2, 60, 4, 8, generator=g)
    loc = torch.rand(2, 10, 4, 2, 3, 2, generator=g) * 1.2 - 0.1
    attn = torch.rand(2, 10, 4, 2, 3, generator=g)
    assert torch.equal(deform.ms_deform_attn(value, shapes, loc, attn),
                       ms_deform_attn_torch(value, shapes, loc, attn))


def test_auction_equals_the_package():
    from dvis_plus_tpu_torch.ops.assignment import auction_lap

    g = torch.Generator().manual_seed(1)
    cost = torch.rand(3, 12, 12, generator=g)
    assert torch.equal(ref_auction(cost), auction_lap(cost))


def test_fp8_control_rounds_linear_inputs():
    lin = layers.Linear(16, 4)
    x = torch.randn(3, 16)
    exact = lin(x)
    layers.set_precision("fp8")
    try:
        q = lin(x)
    finally:
        layers.set_precision("fp32")
    err = float((q - exact).detach().norm() / exact.detach().norm())
    assert 1e-3 < err < 0.2
    assert layers.precision() == "fp32"


def test_meta_matching_is_the_identity():
    x = torch.empty(1, 5, 8, device="meta")
    assert ref_tracker.match_embds(x, x).shape == (1, 5)
