"""``python -m dvis_plus_tpu_torch.cli`` training the families this port
added to the recipe, on the CPU at the tiny widths (``config.TINY_TRAIN``):
Mask2Former on COCO pseudo-videos (``configs/dvis/maskformer_r50_coco.yaml``
on ``tools/synth_data.py::make_coco``) and MinVIS with the ViT-Adapter
(``configs/dvis/minvis_vitl_ytvis19.yaml``, a 2-block trunk of width 32,
frozen) on ``make_ytvis``. Two steps, a checkpoint after each; a run whose
last checkpoint is removed and resumed ends bit-equal to the unbroken one;
the trained parts moved, the ViT trunk did not."""
import os
import sys

import pytest
import torch

from dvis_plus_tpu.data.datasets.categories import YTVIS_2019_CLASSES
from dvis_plus_tpu_torch import cli
from dvis_plus_tpu_torch.config import TINY_TRAIN
from dvis_plus_tpu_torch.core import checkpoint as ckpt

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from synth_data import make_coco, make_ytvis  # noqa: E402

torch.set_num_threads(2)
DATA = ["input.min_size_train=[48,64]", "input.max_size_train=96", "model.criterion.max_num_instances=3",
        "solver.ims_per_batch=2", "model.criterion.train_num_points=64", "solver.max_iter=2",
        "solver.checkpoint_period=1"]
VIT = ["model.backbone.vit_embed_dim=32", "model.backbone.vit_depth=2", "model.backbone.vit_num_heads=2",
       "model.backbone.vit_deform_num_heads=2", "model.backbone.vit_interaction_indexes=[[0,0],[1,1]]",
       "model.backbone.vit_conv_inplane=8", "input.sampling_frame_num=3"]
RUNS = {"maskformer_r50_coco": [], "minvis_vitl_ytvis19": VIT}


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dvis_synth_families"))
    make_coco(root, n_images=4)
    make_ytvis(root, "ytvis_2019", YTVIS_2019_CLASSES, splits=("train",), n_videos=2, length=5)
    return root


def _train(yaml, out, resume=False):
    return cli.main(["--config-file", f"configs/dvis/{yaml}.yaml", "--device", "cpu",
                     *(["--resume"] if resume else []), *TINY_TRAIN, *DATA, *RUNS[yaml],
                     f"output_dir={out}"])


@pytest.mark.parametrize("yaml", sorted(RUNS))
def test_cli_trains_and_resumes_to_the_unbroken_run(yaml, synth_root, monkeypatch, tmp_path):
    monkeypatch.setenv("DVIS_DATASETS", synth_root)
    whole, broken = tmp_path / "whole", tmp_path / "broken"
    assert _train(yaml, whole) == {"step": 2, "device": "cpu"}
    line = (whole / "metrics.jsonl").read_text().splitlines()[0]
    assert '"total_loss"' in line and '"loss_dice_0"' in line
    _train(yaml, broken)
    os.remove(broken / "checkpoints" / "step_0000002.pth")
    assert _train(yaml, broken, resume=True) == {"step": 2, "device": "cpu"}
    a, b = (ckpt.restore(str(d / "checkpoints" / "step_0000002.pth")) for d in (whole, broken))
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for k in a["optimizer"]["mu"]:
        assert torch.equal(a["optimizer"]["mu"][k], b["optimizer"]["mu"][k]), k
    start = ckpt.restore(str(whole / "checkpoints" / "step_0000001.pth"))["model"]
    moved = {k for k in a["model"] if not torch.equal(start[k], a["model"][k])}
    assert any(k.startswith("backbone.") for k in moved)
    assert any(k.startswith("sem_seg_head.") for k in moved)
    assert not any(k.startswith("backbone.vit_module.") for k in moved)
    assert any(k.startswith("backbone.vit_module.") for k in a["model"]) == (yaml != "maskformer_r50_coco")
