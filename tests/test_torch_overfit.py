"""The port twins of ``tests/test_overfit_families.py``: each runs
``chip_smoke.py``'s ``train_overfit`` phase on the CPU (100 steps of the
port's train step at the widths of ``config.TINY_TRAIN`` on a synthetic
YouTube-VIS set through the port's loader); the total loss falls.

- DVIS++ online, the tracker on a frozen segmenter from its seeded
  initialization (stage 2 of
  ``test_staged_dvis_overfit_online_then_offline``);
- MinVIS, the whole segmenter trained (stage 1);
- the staged chain of that JAX test (:101): CTVIS trains the segmenter,
  DVIS++ online its tracker on that segmenter frozen, DVIS++ offline its
  refiner on that online model frozen;
- Mask2Former and Video Mask2Former on two synthetic COCO images made
  pseudo-videos (the ``maskformer_train_overfit`` phase);
- DVIS-DAQ online, the tiny cutter on the segmenter a MinVIS run trained
  (``test_daq_online_overfit``; the ``daq_train_overfit`` phase).

Slow, as the JAX tests are."""
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.slow
CPU = torch.device("cpu")


def test_online_tracker_overfits():
    torch.set_num_threads(4)
    res = chip_smoke.phase_train_overfit(CPU)
    assert res["total_loss"][-1] < res["total_loss"][0], res


def test_minvis_segmenter_overfits():
    torch.set_num_threads(4)
    res = chip_smoke.phase_train_overfit(CPU, "minvis", "minvis_train_overfit")
    assert res["total_loss"][-1] < res["total_loss"][0], res


def test_staged_ctvis_online_offline_chain():
    """Each stage starts from the model the one before trained (its keys
    loaded where they agree) and the stages it does not train stay as they
    were given."""
    torch.set_num_threads(4)
    stage1 = chip_smoke.phase_train_overfit(CPU, "ctvis", "ctvis_train_overfit")
    stage2 = chip_smoke.phase_train_overfit(CPU, "dvis_online", "train_overfit",
                                            weights=stage1["state_dict"])
    stage3 = chip_smoke.phase_train_overfit(CPU, "dvis_offline", "offline_train_overfit",
                                            weights=stage2["state_dict"])
    for res in (stage1, stage2, stage3):
        assert res["total_loss"][-1] < res["total_loss"][0], res["phase"]
    for k, v in stage1["state_dict"].items():  # the segmenter, frozen in stages 2 and 3
        assert torch.equal(stage3["state_dict"][k], v), k
    for k, v in stage2["state_dict"].items():
        if k.startswith("tracker."):
            assert torch.equal(stage3["state_dict"][k], v), k


@pytest.mark.parametrize("arch", ["maskformer", "video_maskformer"])
def test_mask2former_overfits_coco_pseudo_videos(arch):
    torch.set_num_threads(4)
    res = chip_smoke.phase_train_overfit(CPU, arch, f"{arch}_train_overfit")
    assert res["total_loss"][-1] < res["total_loss"][0], res


def test_daq_online_overfits_on_a_trained_segmenter():
    """The cutter trains on the MinVIS run's segmenter, frozen: its loss
    falls and the segmenter stays as it was given."""
    torch.set_num_threads(4)
    stage1 = chip_smoke.phase_train_overfit(CPU, "minvis", "minvis_train_overfit")
    res = chip_smoke.phase_train_overfit(CPU, "daq_online", "daq_train_overfit", weights=stage1["state_dict"])
    assert res["total_loss"][-1] < res["total_loss"][0], res
    for k, v in stage1["state_dict"].items():
        assert torch.equal(res["state_dict"][k], v), k
