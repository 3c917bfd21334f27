"""VPS end to end: the port's CLI (``--device cpu``) and
``train_net_video.py --eval-only`` on ``configs/dvis/dvis_online_r50_vipseg.yaml``
(DVIS++ online) with the tiny overrides of
``tests/test_torch_common.py::E2E_TINY`` and 3 classes (the synthetic set's
2 thing and 1 stuff categories), the same seeded weights, on the synthetic
VIPSeg set (``tools/synth_data.py::make_vipseg``: 2 videos of 6 frames at
64x96, resized to 48x72, two windows of 4 frames, the second ragged). Held
equal: ``pred.json``, every panoptic PNG pixel for pixel, and the printed
VPQ / STQ dict."""
import json
import os
import sys

import numpy as np
import pytest

from tests.test_torch_common import E2E_TINY, e2e_run

OPTS = E2E_TINY + ["model.num_classes=3", "model.tracker.num_layers=1",
                   "model.tracker.feedforward_dim=64"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("e2e_vps"))
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
    from synth_data import make_vipseg

    data = os.path.join(tmp, "data")
    make_vipseg(data, n_videos=2, length=6)
    return e2e_run("configs/dvis/dvis_online_r50_vipseg.yaml", "panoVSPW_vps_video_val", data, tmp,
                   OPTS, "vps")


def test_pred_json_equal(run):
    _, _, port_dir, jax_dir = run
    with open(os.path.join(port_dir, "pred.json")) as f:
        got = json.load(f)
    with open(os.path.join(jax_dir, "pred.json")) as f:
        want = json.load(f)
    assert got == want
    assert [v["video_id"] for v in got["annotations"]] == ["video_0001", "video_0002"]
    assert sum(len(fr["segments_info"]) for v in got["annotations"] for fr in v["annotations"]) > 0


def test_panoptic_pngs_equal(run):
    import cv2

    _, _, port_dir, jax_dir = run
    names = sorted(os.path.relpath(os.path.join(d, f), os.path.join(jax_dir, "pan_pred"))
                   for d, _, fs in os.walk(os.path.join(jax_dir, "pan_pred")) for f in fs)
    assert len(names) == 2 * 6
    for name in names:
        got = cv2.imread(os.path.join(port_dir, "pan_pred", name), cv2.IMREAD_COLOR)
        want = cv2.imread(os.path.join(jax_dir, "pan_pred", name), cv2.IMREAD_COLOR)
        assert got.shape == want.shape == (64, 96, 3)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_vpq_stq_equal(run):
    got, want, _, _ = run
    assert set(got) == set(want) | {"device"} and {"STQ", "videos"} <= set(want)
    assert json.dumps({k: got[k] for k in want}, sort_keys=True) == json.dumps(want, sort_keys=True)
