"""Work counts from known shapes, against hand-worked numbers."""
from __future__ import annotations

import torch

from port_bench.bench import portcfg, registry
from port_bench.tests import common
from port_bench.work import counts, flops, peaks


def test_linear_counts():
    f, b = counts.linear(2, 3, 4, "float32")
    assert f == 2 * 2 * 3 * 4 == 48
    assert b == 4 * (2 * 3 + 3 * 4 + 4 + 2 * 4)


def test_attention_counts():
    f, b = counts.attention(1, 2, 5, 7, 3, "bfloat16")
    assert f == 4 * 2 * 5 * 7 * 3
    assert b == 2 * 2 * 3 * (2 * 5 + 2 * 7)


def test_msdeform_sampling_counts():
    f, b = counts.msdeform_sampling(1, 10, 6, 2, 1, 4, 8, "bfloat16", "float32")
    samples = 6 * 2 * 1 * 4
    assert f == 8 * 8 * samples
    assert b == 2 * 10 * 2 * 8 + 8 * samples + 4 * samples + 2 * 6 * 2 * 8


def test_least_time_takes_the_larger_bound():
    assert peaks.least_time(989e12, 0, "bfloat16") == 1.0
    assert peaks.least_time(0, 3.35e12, "float32") == 1.0
    assert peaks.least_time(67e12, 3.35e12 / 2, "float32") == 1.0


def test_flop_counter_counts_a_product_and_the_sampling():
    a, b = torch.empty(4, 6, device="meta"), torch.empty(6, 5, device="meta")
    assert flops.count(torch.mm, a, b) == 2 * 4 * 6 * 5

    from port_bench.reference import deform

    value = torch.empty(1, 12, 2, 4, device="meta")
    loc = torch.empty(1, 3, 2, 1, 2, 2, device="meta")
    attn = torch.empty(1, 3, 2, 1, 2, device="meta")
    assert flops.count(lambda *a: deform.ms_deform_attn(*a), value, [(3, 4)], loc, attn) == 8 * 4 * (3 * 2 * 1 * 2)


def test_video_count_ignores_how_the_program_runs_it(tmp_path):
    """The count comes from the reference: switching the program's trunk
    attention to its kernel path, or the deformable attention to the other
    form, leaves it where it was; and it grows with the frames."""
    _, entry, _ = registry.workload(common.CELL)
    f = registry.config_file(entry)
    video_flops = registry.adapter(f).video_flops
    base = portcfg.namespace(f, common.TINY).model
    other = portcfg.namespace(f, common.TINY + ("model.backbone.vit_flash_attention=false",
                                                "model.pixel_decoder.msdeform_impl=pallas_local")).model
    kw = dict(padded=(64, 96), image_size=(64, 96), output_size=(64, 96), window=5)
    a = video_flops(base, 7, cache_path=str(tmp_path / "a.json"), **kw)
    b = video_flops(other, 7, cache_path=str(tmp_path / "b.json"), **kw)
    c = video_flops(base, 12, cache_path=str(tmp_path / "a.json"), **kw)
    assert a == b > 0
    assert c > a
    # cached: the same number read back
    assert video_flops(base, 7, cache_path=str(tmp_path / "a.json"), **kw) == a
