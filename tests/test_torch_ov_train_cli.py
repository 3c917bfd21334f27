"""``python -m dvis_plus_tpu_torch.cli_ov`` training on the CPU
(``--device cpu --random-text``, without ``--eval-only``) at the tiny OV
widths of ``tests/test_ov_cli.py::ov_tiny_cfg``, the port's twins of that
file's training tests:

- ``test_ov_train_steps``: the FC-CLIP segmenter (``minvis``), DVIS++ OV
  online and offline on a ``make_ytvis`` set, two steps each;
- ``test_ov_multidataset_supervised_train``: the supervised mixture of
  ``configs/ov/ov_online_convnextl_supervised.yaml`` cut to COCO panoptic
  pseudo-videos (133 classes) and YouTube-VIS 2019 (40), two void rows,
  four steps that reach both sets, a checkpoint a step; a run whose last
  checkpoint is removed and resumed ends
  bit-equal to the unbroken one (finding 3: the JAX CLI parses
  ``--resume`` and reads it nowhere, so it starts again from step 0);
- ``test_ov_vps_train_steps``: DVIS++ OV online on VIPSeg (three classes,
  things first).
"""
import os
import sys

import pytest
import torch

from dvis_plus_tpu.data.datasets.categories import YTVIS_2019_CLASSES
from dvis_plus_tpu_torch import cli_ov
from dvis_plus_tpu_torch.core import checkpoint as ckpt
from dvis_plus_tpu_torch.data.build import CombinedDataLoader

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from synth_data import make_coco, make_vipseg, make_ytvis  # noqa: E402

torch.set_num_threads(2)
# tests/test_ov_cli.py::ov_tiny_cfg's widths and input
OV_TINY = ["model.compute_dtype=float32", "model.ov.clip_embed_dim=24", "model.backbone.clip_depths=[1,1,1,1]",
           "model.backbone.clip_dims=[8,16,24,32]", "model.pixel_decoder.conv_dim=32",
           "model.pixel_decoder.mask_dim=32", "model.pixel_decoder.transformer_enc_layers=1",
           "model.pixel_decoder.transformer_dim_feedforward=64", "model.transformer_decoder.hidden_dim=32",
           "model.transformer_decoder.num_queries=8", "model.transformer_decoder.nheads=4",
           "model.transformer_decoder.dim_feedforward=64", "model.transformer_decoder.dec_layers=2",
           "model.transformer_decoder.mask_dim=32", "model.tracker.num_layers=1",
           "model.tracker.feedforward_dim=64", "model.refiner.num_layers=1", "model.refiner.feedforward_dim=64",
           "model.criterion.train_num_points=64", "model.criterion.max_num_instances=4",
           "input.sampling_frame_num=3", "input.sampling_frame_range=2", "input.min_size_train=[32,48]",
           "input.max_size_train=64", "solver.ims_per_batch=1", "solver.max_iter=2",
           "solver.checkpoint_period=1000"]
MIXTURE = ["datasets.train=[coco_panoptic_video_ov,ytvis_2019_train]",
           "datasets.dataset_type=[image_panoptic,video_instance]", "datasets.dataset_ratio=[0.5,0.5]",
           "datasets.dataset_need_map=[false,false]", "model.ov.num_void_embeddings=2",
           "solver.max_iter=4", "solver.checkpoint_period=1"]


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dvis_synth_ov_train"))
    make_ytvis(root, "ytvis_2019", YTVIS_2019_CLASSES, splits=("train",), n_videos=2, length=5)
    make_coco(root, n_images=3)
    make_vipseg(root)
    return root


def _train(yaml, out, *opts, resume=False):
    return cli_ov.main(["--config-file", f"configs/ov/{yaml}.yaml", "--device", "cpu", "--random-text",
                        *(["--resume"] if resume else []), *OV_TINY, *opts, f"output_dir={out}"])


@pytest.mark.parametrize("yaml,arch", [("ov_online_convnextl_ytvis19", "minvis"),
                                       ("ov_online_convnextl_ytvis19", "dvis_online"),
                                       ("ov_offline_convnextl_ytvis19", "dvis_offline")])
def test_ov_train_steps(yaml, arch, synth_root, monkeypatch, tmp_path):
    """Two steps, a checkpoint after each; what trains moves between them
    and nothing else: the segmenter and its void row (the CLIP trunk
    frozen), the tracker and the void row on the segmenter run without
    gradients, the refiner alone on the frozen online model."""
    monkeypatch.setenv("DVIS_DATASETS", synth_root)
    assert _train(yaml, tmp_path, f"model.meta_architecture={arch}",
                  "solver.checkpoint_period=1") == {"step": 2, "device": "cpu"}
    a, b = (ckpt.restore(str(tmp_path / "checkpoints" / f"step_000000{i}.pth"))["model"] for i in (1, 2))
    moved = {k.split(".")[0] for k in a if not torch.equal(a[k], b[k])}
    assert moved == {"minvis": {"sem_seg_head", "void_embedding"}, "dvis_online": {"tracker", "void_embedding"},
                     "dvis_offline": {"refiner"}}[arch]


def test_ov_multidataset_supervised_train(synth_root, monkeypatch, tmp_path):
    monkeypatch.setenv("DVIS_DATASETS", synth_root)
    whole, broken = tmp_path / "whole", tmp_path / "broken"
    replay = CombinedDataLoader([iter(())] * 2, [0.5, 0.5], seed=0)
    assert {replay.next_index() for _ in range(4)} == {0, 1}  # both sets within the four steps
    assert _train("ov_online_convnextl_supervised", whole, *MIXTURE) == {"step": 4, "device": "cpu"}
    _train("ov_online_convnextl_supervised", broken, *MIXTURE)
    os.remove(broken / "checkpoints" / "step_0000004.pth")
    assert _train("ov_online_convnextl_supervised", broken, *MIXTURE, resume=True) == {"step": 4, "device": "cpu"}
    a, b = (ckpt.restore(str(d / "checkpoints" / "step_0000004.pth")) for d in (whole, broken))
    assert a["step"] == b["step"] == 4 and a["optimizer"]["count"] == b["optimizer"]["count"] == 4
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for k in a["optimizer"]["mu"]:
        assert torch.equal(a["optimizer"]["mu"][k], b["optimizer"]["mu"][k]), k


def test_ov_vps_train_steps(synth_root, monkeypatch, tmp_path):
    monkeypatch.setenv("DVIS_DATASETS", synth_root)
    assert _train("ov_online_convnextl_vipseg", tmp_path, "model.num_classes=3", "input.sampling_frame_num=2",
                  "input.min_size_train=[32,48]", "input.max_size_train=64") == {"step": 2, "device": "cpu"}
