"""The port twin of stage 2 of
``tests/test_overfit_families.py::test_staged_dvis_overfit_online_then_offline``:
DVIS++ online on the tiny configuration, the segmenter frozen (here from its
seeded initialization: the segmenter's own training, MinVIS, is ROADMAP
A14c), 100 steps of the port's train step on a synthetic YouTube-VIS set
through the port's loader; the total loss falls. It runs
``chip_smoke.py``'s ``train_overfit`` phase on the CPU. Slow, as the JAX
test is."""
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.slow


def test_online_tracker_overfits():
    torch.set_num_threads(4)
    res = chip_smoke.phase_train_overfit(torch.device("cpu"))
    assert res["total_loss"][-1] < res["total_loss"][0], res
