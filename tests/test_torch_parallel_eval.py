"""Multi-device eval of the port (``engine/parallel_eval.py``,
``evaluation/dist.py``, ``data/build.py::build_test_loader``).

- The thread fan-out: ``run_device_parallel`` over ``[cpu] * 4`` (7 videos,
  so the workers' stripes are uneven) writes the bytes of the sequential
  run, as the JAX ``engine/parallel_eval.py`` replays them interleaved: VIS
  ``results.json``, VPS ``pred.json`` and panoptic PNGs, VSS PNGs. The
  conflict with ``test.refiner_shard_devices`` raises, as there.
- The processes: the CLI under two gloo ranks (one spawn) evaluates
  YouTube-VIS and VIPSeg, each rank its stripe ``records[rank::2]``; rank 0
  writes the rows rank by rank (rank 0's videos, then rank 1's), as the
  JAX ``evaluation/dist.py`` concatenates them, and the scores equal the
  one-process CLI's; ``UniYTVISEvaluator`` gathers its BDD keys the same
  way and rank 0 alone writes.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from dvis_plus_tpu_torch.cli import build_model
from dvis_plus_tpu_torch.engine.inference import run_vis_inference, run_vps_inference, run_vss_inference
from dvis_plus_tpu_torch.engine.parallel_eval import run_device_parallel
from dvis_plus_tpu_torch.evaluation.evaluators import VPSEvaluator, VSSEvaluator, YTVISEvaluator
from tests import torch_ddp
from tests.test_torch_common import E2E_TINY, images, tiny_cfg

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from synth_data import make_vipseg, make_ytvis  # noqa: E402

torch.set_num_threads(2)

CPU4 = [torch.device("cpu")] * 4


def _videos():
    out = []
    for vid, T in enumerate([5, 3, 4, 3, 5, 4, 3], 1):
        out.append({"images": images(T, seed=70 + vid), "image_size": np.asarray([56, 96]),
                    "height": 48 + 8 * (vid % 3), "width": 72, "video_id": vid,
                    "file_names": [f"v{vid}/{t:05d}.jpg" for t in range(T)]})
    return out


def _stripes(videos):
    return lambda i, n: iter(videos[i::n])


def _model():
    cfg = tiny_cfg()
    torch.manual_seed(0)
    return cfg, build_model(cfg.model).eval()


def _files(root):
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _task(task, cfg, model, videos, out_dir, devices):
    if task == "vis":
        ev = YTVISEvaluator("synthetic", out_dir)
        run_device_parallel(cfg, lambda m, ld, e: run_vis_inference(cfg, m, ld, e), _stripes(videos), ev,
                            model, devices)
        ev.write_results()
    elif task == "vps":
        ev = VPSEvaluator("synthetic", out_dir)
        run_device_parallel(cfg, lambda m, ld, e: run_vps_inference(cfg, m, ld, e, 3), _stripes(videos),
                            ev, model, devices)
        ev.evaluate()
    else:
        ev = VSSEvaluator("synthetic", out_dir)
        run_device_parallel(cfg, lambda m, ld, e: run_vss_inference(cfg, m, ld, e), _stripes(videos),
                            ev, model, devices)
        ev.evaluate()
    return _files(out_dir)


@pytest.mark.parametrize("task", ["vis", "vps", "vss"])
def test_thread_fan_out_writes_the_sequential_bytes(task, tmp_path):
    cfg, model = _model()
    videos = _videos()
    want = _task(task, cfg, model, videos, str(tmp_path / "seq"), None)
    got = _task(task, cfg, model, videos, str(tmp_path / "par"), CPU4)
    assert want and sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    if task == "vis":
        rows = json.loads(want["results.json"])
        assert [r["video_id"] for r in rows] == sorted(r["video_id"] for r in rows)
        assert len({r["video_id"] for r in rows}) == len(videos)


def test_workers_run_their_own_copies_on_their_devices(tmp_path):
    cfg, model = _model()
    seen = []

    def driver(m, loader, ev):
        seen.append((id(m), str(next(m.parameters()).device), [v["video_id"] for v in loader]))

    run_device_parallel(cfg, driver, _stripes(_videos()), YTVISEvaluator("x", str(tmp_path)), model, CPU4)
    assert sorted(v for _, _, vids in seen for v in vids) == list(range(1, 8))
    assert sorted(vids for _, _, vids in seen) == [[1, 5], [2, 6], [3, 7], [4]]
    assert len({i for i, _, _ in seen} | {id(model)}) == 5 and {d for _, d, _ in seen} == {"cpu"}


def test_eval_devices_and_refiner_shards_conflict(tmp_path):
    cfg, model = _model()
    cfg.test.refiner_shard_devices = 2
    with pytest.raises(ValueError, match="refiner_shard_devices"):
        run_device_parallel(cfg, lambda m, ld, e: None, _stripes(_videos()),
                            YTVISEvaluator("x", str(tmp_path)), model, CPU4)


def test_a_worker_exception_reaches_the_caller(tmp_path):
    cfg, model = _model()

    def driver(m, loader, ev):
        for v in loader:
            if v["video_id"] == 6:
                raise KeyError("video 6")

    with pytest.raises(KeyError, match="video 6"):
        run_device_parallel(cfg, driver, _stripes(_videos()), YTVISEvaluator("x", str(tmp_path)), model, CPU4)


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

YTVIS_OPTS = E2E_TINY + ["model.tracker.num_layers=1", "model.tracker.feedforward_dim=64",
                         "datasets.test=[ytvis_2019_val]"]
VPS_OPTS = E2E_TINY + ["model.num_classes=3", "model.tracker.num_layers=1",
                       "model.tracker.feedforward_dim=64"]
RUNS = {"vis": ("configs/dvis/dvis_online_r50_ytvis19.yaml", YTVIS_OPTS),
        "vps": ("configs/dvis/dvis_online_r50_vipseg.yaml", VPS_OPTS)}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from dvis_plus_tpu_torch.data.datasets.categories import YTVIS_2019_CLASSES

    root = str(tmp_path_factory.mktemp("synth_eval"))
    make_ytvis(root, "ytvis_2019", YTVIS_2019_CLASSES, splits=("valid",), n_videos=5, length=4)
    make_vipseg(root, n_videos=3, length=4)
    return root


def _argv(task, out):
    yaml, opts = RUNS[task]
    return ["--config-file", yaml, "--eval-only", "--device", "cpu", *opts, f"output_dir={out}"]


@pytest.fixture(scope="module")
def two_ranks(data, tmp_path_factory):
    """One spawn of two gloo ranks: the CLI's VIS and VPS evals, then the
    MOTS evaluator's gather; and the one-process CLI runs beside them."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    spec = {"data": data, "argv": {t: _argv(t, str(tmp / f"{t}_2")) for t in RUNS},
            "uni": str(tmp / "uni")}
    ranks = torch_ddp.spawn("eval_ranks", spec, tmp)
    os.environ["DVIS_DATASETS"] = data
    from dvis_plus_tpu_torch import cli

    alone = {t: cli.main(_argv(t, str(tmp / f"{t}_1"))) for t in RUNS}
    return tmp, ranks, alone


def test_two_rank_cli_writes_the_rows_rank_by_rank(two_ranks):
    from dvis_plus_tpu_torch.data.catalog import get_dataset

    tmp, ranks, alone = two_ranks
    path = "inference/ytvis_2019_val/results.json"
    with open(tmp / "vis_1" / path) as f:
        seq = json.load(f)
    with open(tmp / "vis_2" / path) as f:
        par = json.load(f)
    ids = [r["video_id"] for r in get_dataset("ytvis_2019_val")]
    by_video = {v: [r for r in seq if r["video_id"] == v] for v in ids}
    assert len(ids) == 5 and all(by_video.values())
    assert par == [r for v in ids[0::2] + ids[1::2] for r in by_video[v]]
    want = alone["vis"]["ytvis_2019_val"]
    for rank in ranks:
        got = rank["vis"]["ytvis_2019_val"]
        assert got["predictions"] == want["predictions"] == len(seq)
    assert ranks[0]["vis"]["ytvis_2019_val"]["AP"] == want["AP"]
    assert "AP" not in ranks[1]["vis"]["ytvis_2019_val"]  # rank 0 alone scores


def test_two_rank_cli_writes_vps_pred_json_rank_by_rank(two_ranks):
    tmp, ranks, alone = two_ranks
    name = "panoVSPW_vps_video_val"
    with open(tmp / "vps_1" / "inference" / name / "pred.json") as f:
        seq = json.load(f)["annotations"]
    with open(tmp / "vps_2" / "inference" / name / "pred.json") as f:
        par = json.load(f)["annotations"]
    assert len(seq) == 3 and par == [seq[0], seq[2], seq[1]]
    seq_png = _files(tmp / "vps_1" / "inference" / name / "pan_pred")
    assert seq_png and _files(tmp / "vps_2" / "inference" / name / "pan_pred") == seq_png
    want = alone["vps"][name]
    got = ranks[0]["vps"][name]
    assert {k: v for k, v in got.items() if k != "device"} == {k: v for k, v in want.items() if k != "device"}
    assert ranks[1]["vps"][name]["videos"] == 3


def test_two_rank_mots_evaluator_gathers_its_bdd_keys(two_ranks):
    tmp, ranks, _ = two_ranks
    with open(tmp / "uni" / "results.json") as f:
        rows = json.load(f)
    assert rows == torch_ddp.uni_rows(0) + torch_ddp.uni_rows(1)
    with open(tmp / "uni" / "frames.json") as f:
        assert json.load(f) == [{"rank": 0, "i": 0}, {"rank": 1, "i": 0}, {"rank": 1, "i": 1}]
    with open(tmp / "uni" / "extra.json") as f:
        assert json.load(f) == [{"rank": 1}]
    assert [r["files"] for r in ranks] == [["extra.json", "frames.json", "results.json"]] * 2
