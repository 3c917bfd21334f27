"""DVIS-DAQ's other routes end to end, the port's CLI (``--device cpu``)
against ``train_net_video.py --eval-only`` with the same seeded weights and
the settings of ``tests/test_torch_e2e_daq.py``:

- ``configs/daq/daq_online_r50_ytvis19.yaml`` with ``test.task=mots`` on
  the synthetic BDD100K seg-track set (``UniYTVISEvaluator``, 8 classes):
  ``results.json`` equal row for row, and the AP;
- ``configs/daq/daq_online_r50_vipseg.yaml`` (VPS through the cutter's
  sequences, 3 classes, the synthetic VIPSeg set: 2 videos of 6 frames):
  ``pred.json`` and every panoptic PNG equal;
- ``configs/daq/daq_vos_r50_ytvos.yaml`` (VOS, the class-agnostic SOT
  mapper) through the port's CLI alone: ``{"task": "vos"}`` as the JAX CLI
  returns, and no PNG, since no mapper gives first-frame masks.

MOTS rows may differ in at most 2 mask pixels in all, for the reason
``tests/test_torch_e2e_daq.py`` gives."""
import json
import os
import sys

import numpy as np
import pytest

from tests.test_torch_common import (
    DAQ_FLIP_PIXELS,
    DAQ_TINY,
    assert_rows_equal,
    e2e_daq_runs,
    e2e_results_rows,
)

RUNS = {  # tag: (yaml, dataset, extra overrides)
    "mots": ("configs/daq/daq_online_r50_ytvis19.yaml", "bdd_seg_track_val",
             ["test.task=mots", "model.num_classes=8"]),
    "vps": ("configs/daq/daq_online_r50_vipseg.yaml", "panoVSPW_vps_video_val", ["model.num_classes=3"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("e2e_daq_tasks"))
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
    from synth_data import make_vipseg, make_ytvis

    from dvis_plus_tpu.data.datasets.categories import BDD_TRACK_CLASSES

    data = os.path.join(tmp, "data")
    make_ytvis(data, "bdd", BDD_TRACK_CLASSES, splits=("val",), n_videos=2, length=8, layout="bdd")
    # YouTube-VOS as the class-agnostic loaders read it: images under
    # ytvos/JPEGImages, every object of category 1
    make_ytvis(data, "ytvos", ["object"], splits=("val",), n_videos=1, length=3)
    os.rename(os.path.join(data, "ytvos", "val", "JPEGImages"), os.path.join(data, "ytvos", "JPEGImages"))
    with open(os.path.join(data, "ytvos", "val.json")) as f:
        vos = json.load(f)
    for ann in vos["annotations"]:
        ann["category_id"] = 1
    with open(os.path.join(data, "ytvos", "val.json"), "w") as f:
        json.dump(vos, f)
    make_vipseg(data, n_videos=2, length=6)
    return {**e2e_daq_runs(tmp, data, RUNS), "data": data}


def test_mots_results_json_equal(runs):
    got, want = e2e_results_rows(runs["mots"])
    assert assert_rows_equal(got, want, max_pixels=DAQ_FLIP_PIXELS) <= DAQ_FLIP_PIXELS
    assert all(1 <= r["category_id"] <= 8 for r in got)  # BDD's 1-based official ids
    port_res, jax_res, _, _ = runs["mots"]
    assert {k: port_res[k] for k in ("AP", "AP50")} == {k: jax_res[k] for k in ("AP", "AP50")}


def test_daq_vps_pred_json_and_pngs_equal(runs):
    import cv2

    _, _, port_dir, jax_dir = runs["vps"]
    with open(os.path.join(port_dir, "pred.json")) as f:
        got = json.load(f)
    with open(os.path.join(jax_dir, "pred.json")) as f:
        want = json.load(f)
    assert got == want
    names = sorted(os.path.relpath(os.path.join(d, f), os.path.join(jax_dir, "pan_pred"))
                   for d, _, fs in os.walk(os.path.join(jax_dir, "pan_pred")) for f in fs)
    assert len(names) == 2 * 6
    for name in names:
        a = cv2.imread(os.path.join(port_dir, "pan_pred", name), cv2.IMREAD_COLOR)
        b = cv2.imread(os.path.join(jax_dir, "pan_pred", name), cv2.IMREAD_COLOR)
        assert a.shape == b.shape == (64, 96, 3)
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_vos_routes_and_writes_no_png(runs, tmp_path):
    """The VOS YAML through the port's CLI: the DAQ eval loop with the
    class-agnostic SOT mapper; ``{"task": "vos"}`` as the JAX CLI returns
    (``train_net_video.py::run_task_eval``), and, with no first-frame masks
    from any mapper, no PNG, as ``_vos_output`` in both packages."""
    from dvis_plus_tpu_torch import cli

    old = os.environ.get("DVIS_DATASETS")
    os.environ["DVIS_DATASETS"] = runs["data"]
    try:
        res = cli.main(["--config-file", "configs/daq/daq_vos_r50_ytvos.yaml", "--eval-only", "--device",
                        "cpu", *DAQ_TINY, f"output_dir={tmp_path}"])
    finally:
        if old is None:
            del os.environ["DVIS_DATASETS"]
        else:
            os.environ["DVIS_DATASETS"] = old
    assert res == {"ytvos_val": {"task": "vos", "device": "cpu"}}
    assert not [f for _, _, fs in os.walk(tmp_path) for f in fs if f.endswith(".png")]
