"""The program's tracer (``dvis_plus_tpu_torch/utils/trace.py``): off, it
keeps nothing and opens no profiler range; on, its records nest by thread,
its spans sit on a CPU profiler's timeline as ``dvis:<name>``, and the eval
loops' ``timings`` read the same with it on or off. The VSS loop on the tiny
DVIS++ offline model, every window paged, counts the paged bytes that the
tensors' shapes and dtypes give, and its class maps are bit-equal with the
tracer on and off, and from the mapper's uint8 canvas (normalized on the
device, ``eval.frames_on_card``) and from the float32 canvas the mapper
built before. The CLI's ``--trace-out`` writes what the tracer kept."""
import copy
import json
import threading

import cv2
import numpy as np
import pytest
import torch

from dvis_plus_tpu_torch import cli
from dvis_plus_tpu_torch.data.mapper import YTVISDatasetMapper
from dvis_plus_tpu_torch.engine import inference
from dvis_plus_tpu_torch.utils import trace
from tests.test_torch_common import H_IN, W_IN, host_canvas, jax_offline_model_and_params, port_model

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


class Clock:
    """A clock that moves only when told: reading it costs no time, so
    spans read the same with the tracer on or off."""

    def __init__(self):
        self.ns = 0

    def __call__(self):
        return self.ns

    def advance(self, ms: float):
        self.ns += int(ms * 1e6)


def _chrome_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def test_off_keeps_nothing_and_opens_no_range(monkeypatch, tmp_path):
    def no_clock():
        raise AssertionError("the clock was read with the tracer off")

    monkeypatch.setattr(trace, "_clock", no_clock)
    assert trace.span("x") is trace.span("y") is trace._NULL  # the flag, and nothing else
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("outer", video=3):
            with trace.span("inner"):
                trace.count("things", 5)
                torch.ones(4).add_(1)
    assert trace.records() == [] and trace.counters() == {} and trace.totals() == {}
    names = [str(e.get("name", "")) for e in _chrome_events(prof, tmp_path)]
    assert not any(n.startswith(trace.PREFIX) for n in names)


def test_nesting_parents_and_self_time(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(trace, "_clock", clock)
    trace.enable()
    with trace.span("outer", video="v1"):
        clock.advance(1)
        for _ in range(2):
            with trace.span("inner"):
                clock.advance(3)
                trace.count("rounds", 2)
        clock.advance(2)
    with trace.span("inner"):
        clock.advance(4)
    recs = {(r.name, r.start_ns): r for r in trace.records()}
    outer = next(r for r in recs.values() if r.name == "outer")
    inner = sorted((r for r in recs.values() if r.name == "inner"), key=lambda r: r.start_ns)
    assert outer.parent is None and outer.video == "v1"
    assert [r.parent for r in inner] == [outer.id, outer.id, None]
    assert len({r.thread for r in recs.values()}) == 1
    t = trace.totals()
    assert t["outer"] == {"calls": 1, "host_s": pytest.approx(9e-3), "self_s": pytest.approx(3e-3)}
    assert t["inner"] == {"calls": 3, "host_s": pytest.approx(10e-3), "self_s": pytest.approx(10e-3)}
    assert trace.counters() == {"rounds": 4}
    trace.reset()
    assert trace.records() == [] and trace.counters() == {}


def test_two_threads_keep_their_own_stacks():
    trace.enable()
    opened, release = threading.Event(), threading.Event()

    def worker():
        with trace.span("worker"):
            opened.set()
            release.wait(10)
            with trace.span("worker.child"):
                trace.count("n")

    with trace.span("main"):
        th = threading.Thread(target=worker)
        th.start()
        assert opened.wait(10)
        with trace.span("main.child"):  # opened while the worker's span is open
            trace.count("n")
        release.set()
        th.join(10)
    assert not th.is_alive()
    by_name = {r.name: r for r in trace.records()}
    assert by_name["worker"].parent is None and by_name["main"].parent is None
    assert by_name["worker.child"].parent == by_name["worker"].id
    assert by_name["main.child"].parent == by_name["main"].id
    assert by_name["worker"].thread != by_name["main"].thread
    assert trace.counters() == {"n": 2}


def test_spans_sit_inside_their_callers_profiler_range(tmp_path):
    trace.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            with trace.span("a"):
                with trace.span("b"):
                    torch.ones(8).mul_(2)
            with trace.span("c"):
                torch.ones(8).mul_(3)
    ranges = {str(e["name"]): e for e in _chrome_events(prof, tmp_path)
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    assert {"caller", "dvis:a", "dvis:b", "dvis:c"} <= set(ranges)

    def inside(inner, outer):
        i, o = ranges[inner], ranges[outer]
        return o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]

    assert inside("dvis:a", "caller") and inside("dvis:b", "dvis:a") and inside("dvis:c", "caller")
    assert {r.name for r in trace.records()} == {"a", "b", "c"}


def test_timings_are_the_spans_seconds_on_or_off(monkeypatch):
    """A loop's ``timings`` key gets its span's seconds whether the tracer is
    on or not, and inner spans without a key leave it as it is."""
    def loop(timings):
        for _ in range(3):
            with trace.span("eval.post", timings=timings, key="post_s"):
                clock.advance(2)
                with trace.span("eval.download"):
                    clock.advance(1)
                with trace.span("eval.evaluator", timings=timings, key="png_s"):
                    clock.advance(5)

    got = []
    for on in (False, True):
        clock = Clock()
        monkeypatch.setattr(trace, "_clock", clock)
        (trace.enable if on else trace.disable)()
        timings = {}
        loop(timings)
        got.append(timings)
    assert got[0] == got[1] == {"post_s": pytest.approx(24e-3), "png_s": pytest.approx(15e-3)}
    assert trace.totals()["eval.post"]["self_s"] == pytest.approx(6e-3)


# -- the VSS loop on the tiny DVIS++ offline model, every window paged --------

LENGTHS = (4, 7)  # frames of the two videos; window 3: a padded tail window each


def _videos(root):
    rng = np.random.RandomState(11)
    recs = []
    for v, T in enumerate(LENGTHS):
        files = []
        for t in range(T):
            path = str(root / f"v{v}_{t:02d}.jpg")
            cv2.imwrite(path, rng.randint(0, 255, (H_IN, W_IN, 3), np.uint8))
            files.append(path)
        recs.append({"video_id": f"video_{v}", "length": T, "file_names": files,
                     "height": H_IN, "width": W_IN})
    return recs


class MapRecorder:
    def __init__(self, clock=None):
        self.maps, self.clock = {}, clock

    def process(self, video_id, file_names, sem):
        self.maps[video_id] = sem.copy()
        if self.clock is not None:
            self.clock.advance(2)


@pytest.fixture(scope="module")
def vss_runs(tmp_path_factory):
    """run_vss_inference with the tracer off, then on, on a clock that only
    the forward and the evaluator move: (cfg, [(recorder, timings, totals,
    counters) of the run off and of the run on], the same of a traced run
    over the float32 canvases the mapper built before)."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("trace_vss")
    cfg, _, params = jax_offline_model_and_params()
    cfg = copy.deepcopy(cfg)
    cfg.model.tracker.matcher_solver = "auction"  # the tiny settings pick jv
    cfg.test.offline_mf_budget_gb = 1e-9  # every window pages
    cfg.input.min_size_test, cfg.input.max_size_test = H_IN, W_IN
    mp.delenv("DVIS_OFFLINE_MF_BUDGET_GB", raising=False)
    model = port_model(cfg, params)
    recs = _videos(root)
    mapper = YTVISDatasetMapper(cfg)
    clock = Clock()
    mp.setattr(trace, "_clock", clock)
    forward = inference._forward

    def timed_forward(*args, **kwargs):
        clock.advance(7)
        return forward(*args, **kwargs)

    mp.setattr(inference, "_forward", timed_forward)
    out = []
    host = [dict(s, images=host_canvas(cfg, s)) for s in (mapper(r) for r in recs)]
    try:
        for on, samples in ((False, None), (True, None), (True, host)):
            trace.reset()
            (trace.enable if on else trace.disable)()
            rec, timings = MapRecorder(clock), {}
            loader = (mapper(r) for r in recs) if samples is None else iter(samples)
            inference.run_vss_inference(cfg, model, loader, rec, timings=timings)
            trace.disable()
            out.append((rec, timings, trace.totals(), trace.counters()))
    finally:
        mp.undo()
        trace.reset()
    return cfg, out[:2], out[2]


def test_vss_class_maps_and_timings_equal_on_and_off(vss_runs):
    _, ((off, t_off, tot_off, c_off), (on, t_on, _, _)), _ = vss_runs
    assert sorted(off.maps) == sorted(on.maps) == ["video_0", "video_1"]
    for vid in off.maps:
        assert off.maps[vid].dtype == np.uint8 and off.maps[vid].shape == (LENGTHS[int(vid[-1])], H_IN, W_IN)
        np.testing.assert_array_equal(on.maps[vid], off.maps[vid])
    assert tot_off == {} and c_off == {}
    assert t_off == t_on
    assert t_on == {"model_s": pytest.approx(14e-3), "post_s": pytest.approx(4e-3),
                    "download_s": 0.0, "png_s": pytest.approx(4e-3)}


def test_vss_spans_and_counters(vss_runs):
    cfg, (_, (_, _, totals, counters)), _ = vss_runs
    n = len(LENGTHS)
    for name in ("data.decode", "data.normalize", "eval.forward", "eval.post", "eval.class_map",
                 "eval.download", "eval.evaluator"):
        assert totals[name]["calls"] == n, name
    assert counters["data.frames"] == sum(LENGTHS)
    assert counters["assignment.auction_calls"] >= 1
    assert totals["assignment.auction"]["calls"] == counters["assignment.auction_calls"]
    assert counters["assignment.auction_checks"] >= counters["assignment.auction_calls"]
    assert counters["assignment.auction_rounds"] >= counters["assignment.auction_checks"]
    # the chunks' page-in runs inside the class map's span
    assert totals["eval.class_map"]["self_s"] <= totals["eval.class_map"]["host_s"]

    # the bytes the shapes and dtypes give: mask features (mask_dim channels,
    # fp32 here, at stride 4) out by whole windows and back by valid frames;
    # the refined masks (Q queries) out as fp16, back a chunk at a time
    W_sz, Q = cfg.test.window_size, cfg.model.transformer_decoder.num_queries
    C, px = cfg.model.pixel_decoder.mask_dim, (H_IN // 4) * (W_IN // 4)
    windows = sum(-(-T // W_sz) for T in LENGTHS)
    frames = sum(LENGTHS)
    mf_frame, mask_frame = C * px * 4, Q * px * 2
    assert counters["eval.page_out_bytes"] == windows * W_sz * mf_frame + frames * mask_frame
    assert counters["eval.page_in_bytes"] == frames * mf_frame + frames * mask_frame
    assert totals["eval.page_out"]["calls"] == 2 * windows  # mask features, refined masks
    assert totals["eval.page_in"]["calls"] == 2 * windows  # mask features, chunks


def test_vss_class_maps_from_the_uint8_canvas_equal_the_float32_ones(vss_runs):
    """The mapper's uint8 canvas, normalized on the device, and the float32
    canvas built on the host the way the mapper did before give the same
    class maps, bit for bit."""
    _, (_, (on, _, _, _)), (host, _, _, _) = vss_runs
    assert sorted(host.maps) == sorted(on.maps) == ["video_0", "video_1"]
    for vid in on.maps:
        np.testing.assert_array_equal(host.maps[vid], on.maps[vid])


def test_frames_on_card_counts_every_mapped_frame(vss_runs):
    """Every frame the eval mapper hands over is normalized on the device
    (the padded tail windows' repeats not counted); none of a float32
    canvas."""
    _, (_, (_, _, _, counters)), (_, _, _, host_counters) = vss_runs
    assert counters["eval.frames_on_card"] == counters["data.frames"] == sum(LENGTHS)
    assert host_counters.get("eval.frames_on_card", 0) == 0 and "data.frames" not in host_counters


YAML = "configs/dvis/dvis_offline_vitl_ytvis19.yaml"
TINY = [  # the tiny ViT-Adapter of tests/test_torch_cli.py
    "model.compute_dtype=float32",
    "model.backbone.vit_embed_dim=32", "model.backbone.vit_depth=2",
    "model.backbone.vit_num_heads=2", "model.backbone.vit_deform_num_heads=2",
    "model.backbone.vit_interaction_indexes=[[0,0],[1,1]]", "model.backbone.vit_conv_inplane=8",
    "model.pixel_decoder.conv_dim=32", "model.pixel_decoder.mask_dim=32",
    "model.pixel_decoder.transformer_enc_layers=1",
    "model.pixel_decoder.transformer_dim_feedforward=64",
    "model.transformer_decoder.hidden_dim=32", "model.transformer_decoder.num_queries=8",
    "model.transformer_decoder.nheads=4", "model.transformer_decoder.dim_feedforward=64",
    "model.transformer_decoder.dec_layers=2", "model.transformer_decoder.mask_dim=32",
    "model.transformer_decoder.reid_hidden_dim=32",
    "model.tracker.num_layers=1", "model.tracker.feedforward_dim=64",
    "model.refiner.num_layers=1", "model.refiner.feedforward_dim=64",
    "input.min_size_test=48", "input.max_size_test=80",
    "test.window_size=4", "test.max_num=5", "datasets.test=[ytvis_2019_val]",
]


def test_cli_trace_out_writes_the_tracer(monkeypatch, tmp_path):
    from dvis_plus_tpu_torch.data.datasets.categories import YTVIS_2019_CLASSES
    from dvis_plus_tpu_torch.data.datasets.ytvis import register_all_ytvis
    from dvis_plus_tpu_torch.tools.synth_data import make_ytvis

    root = str(tmp_path / "synth")
    make_ytvis(root, "ytvis_2019", YTVIS_2019_CLASSES, n_videos=2, length=5)
    register_all_ytvis(root)
    monkeypatch.setenv("DVIS_DATASETS", root)
    out_file = tmp_path / "out" / "trace.json"
    with pytest.raises(SystemExit):
        cli.main(["--config-file", YAML, "--device", "cpu", "--trace-out", str(out_file), *TINY])
    res = cli.main(["--config-file", YAML, "--eval-only", "--device", "cpu", "--trace-out", str(out_file),
                    *TINY, f"output_dir={tmp_path / 'eval'}"])
    assert res["ytvis_2019_val"]["predictions"] == 10
    assert not trace.enabled()
    with open(out_file) as f:
        got = json.load(f)
    assert set(got) == {"totals", "counters", "records"}
    for name in ("data.decode", "data.normalize", "eval.forward", "eval.post", "eval.evaluator"):
        assert got["totals"][name]["calls"] == 2, name
    assert got["counters"]["data.frames"] == got["counters"]["eval.frames_on_card"] == 10
    recs = got["records"]
    assert len(recs) == sum(t["calls"] for t in got["totals"].values())
    assert set(recs[0]) == {"name", "thread", "start_ns", "end_ns", "id", "parent", "video"}
    # the VIS loop decodes on its prefetch thread and post-processes on a worker
    threads = {r["name"]: r["thread"] for r in recs}
    assert threads["data.decode"] != threads["eval.forward"] != threads["eval.post"]
