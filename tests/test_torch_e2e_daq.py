"""DVIS-DAQ VIS end to end: the port's CLI (``--device cpu``) and
``train_net_video.py --eval-only`` with the same seeded weights on the
synthetic YouTube-VIS 2019 and OVIS sets (2 videos of 8 frames), the tiny
overrides of ``tests/test_torch_common.py::E2E_TINY`` and a cutter of 2
layers with a table of 6 slots (2 background slots, 8 new-instance queries,
kick-out after 2 missed frames, sequences shorter than 3 frames dropped as
noise): ``configs/daq/daq_online_r50_ytvis19.yaml`` and
``configs/daq/daq_offline_r50_ovis.yaml`` (the refiner over the 20 best
sequences, fewer than 20 here) write the same ``results.json`` row for row
(ids, categories, scores within 1e-4, and the masks: equal RLE strings, but
for at most 2 pixels in a run). The MOTS, VPS and VOS routes are in
``tests/test_torch_e2e_daq_tasks.py``.

Each DAQ YAML with the R50 segmenter inherits
``transformer_decoder.reid_branch: true``, with which neither package can
build a DAQ model, so both CLIs get ``reid_branch=false``. The class heads
are scaled (x8) so that the cutter's selection threshold separates queries,
and the mask heads (x5 a layer) so that mask logits are of a trained
model's order. The DAQ loop rounds the sequences' mask logits to fp16 before
the upsampling, in both packages: their fp32 logits agree to about 1e-6, so
about 1 % of the fp16 values lie one unit apart, and an upsampled pixel
whose logit is within that unit of 0 can fall on the other side of the
threshold. ``tests/test_torch_daq.py`` holds the fp16 masks within one unit
and every fp32 value to 1e-4. The JAX CLIs run at once in subprocesses while
the port's run."""
import os
import sys

import pytest

from tests.test_torch_common import DAQ_FLIP_PIXELS, assert_rows_equal, e2e_daq_runs, e2e_results_rows

RUNS = {  # tag: (yaml, dataset, extra overrides)
    "online": ("configs/daq/daq_online_r50_ytvis19.yaml", "ytvis_2019_val", []),
    "offline": ("configs/daq/daq_offline_r50_ovis.yaml", "ovis_val", []),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("e2e_daq"))
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
    from synth_data import make_ytvis

    from dvis_plus_tpu.data.datasets.categories import OVIS_CLASSES, YTVIS_2019_CLASSES

    data = os.path.join(tmp, "data")
    make_ytvis(data, "ytvis_2019", YTVIS_2019_CLASSES, splits=("valid",), n_videos=2, length=8)
    make_ytvis(data, "ovis", OVIS_CLASSES, splits=("valid",), n_videos=2, length=8, layout="ovis")
    return e2e_daq_runs(tmp, data, RUNS)


@pytest.mark.parametrize("tag", ["online", "offline"])
def test_vis_results_json_equal(runs, tag):
    got, want = e2e_results_rows(runs[tag])
    assert assert_rows_equal(got, want, max_pixels=DAQ_FLIP_PIXELS) <= DAQ_FLIP_PIXELS
    assert {r["video_id"] for r in got} == {1, 2}
    assert len({r["score"] for r in got}) > 1  # the scores differ from one sequence to the next
