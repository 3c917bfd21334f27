"""VSS end to end: the port's CLI (``--device cpu``) and
``train_net_video.py --eval-only`` on ``configs/dvis/dvis_offline_r50_vspw.yaml``
(DVIS++ offline, whose online tracker's logits join the class scores as
aux; 124 classes) with the tiny overrides of
``tests/test_torch_common.py::E2E_TINY``, the same seeded weights, on the
synthetic VSPW set (``tools/synth_data.py::make_vspw``: 2 videos of 6 frames
at 64x96). The shorter edge goes to 96, so the model sees 96x144 (padded to
96x160) and the second resize downsamples to 64x96, as VSPW's 480p output of
a 720p input does. The class and mask heads' weights are scaled up (x4,
x6 a layer) so that the random model's class maps hold several classes.
Held equal: every class PNG pixel for pixel and the
printed mIoU / VC dict."""
import json
import os
import sys

import numpy as np
import pytest

from tests.test_torch_common import E2E_TINY, e2e_run

OPTS = E2E_TINY + ["input.min_size_test=96", "input.max_size_test=160",
                   "model.tracker.num_layers=1", "model.tracker.feedforward_dim=64",
                   "model.refiner.num_layers=1", "model.refiner.feedforward_dim=64"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("e2e_vss"))
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
    from synth_data import make_vspw

    data = os.path.join(tmp, "data")
    make_vspw(data, n_videos=2, length=6)
    return e2e_run("configs/dvis/dvis_offline_r50_vspw.yaml", "VSPW_vss_video_val", data, tmp,
                   OPTS, "vss", scales={"class_embed": 4.0, "mask_embed": 6.0})


def test_class_pngs_equal(run):
    import cv2

    _, _, port_dir, jax_dir = run
    names = sorted(os.path.relpath(os.path.join(d, f), jax_dir)
                   for d, _, fs in os.walk(jax_dir) for f in fs if f.endswith(".png"))
    assert len(names) == 2 * 6
    classes = set()
    for name in names:
        got = cv2.imread(os.path.join(port_dir, name), cv2.IMREAD_GRAYSCALE)
        want = cv2.imread(os.path.join(jax_dir, name), cv2.IMREAD_GRAYSCALE)
        assert got.shape == want.shape == (64, 96)
        np.testing.assert_array_equal(got, want, err_msg=name)
        classes |= set(np.unique(got).tolist())
    assert len(classes) > 1


def test_miou_vc_equal(run):
    got, want, _, _ = run
    assert set(got) == set(want) | {"device"} and {"mIoU", "VC8", "videos"} <= set(want)
    assert json.dumps({k: got[k] for k in want}, sort_keys=True) == json.dumps(want, sort_keys=True)
