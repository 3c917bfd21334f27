"""The port's training data for VPS, VSS and the class-agnostic object sets
against the JAX package's, and DVIS-DAQ trained on VIPSeg through the CLI:

- the panoptic (VIPSeg, ``make_vipseg``), semantic (VSPW, ``make_vspw``)
  and SOT (every object category 0, on a ``make_ytvis`` set) training
  mappers give the JAX mappers' arrays bit for bit, clip seed by clip seed,
  with the categories from the set's metadata, and the panoptic mapper
  without categories (dataset ids pass through) and with a list that
  renumbers them (things first);
- ``build_combined_train_loader`` gives the JAX loader's batches bit for
  bit (one JAX worker: its threads hand clips over as they finish);
- ``python -m dvis_plus_tpu_torch.cli`` trains the tiny DVIS-DAQ online on
  the VIPSeg set (2 clips a batch, each cut to 2 of its 3 frames by the
  curriculum, stage 3 from step 2), writes its checkpoints, and a run
  broken after step 2 and resumed ends bit-equal to the unbroken one."""
import os
import sys

import numpy as np
import pytest
import torch

from dvis_plus_tpu.core.config import load_config as jax_load_config
from dvis_plus_tpu.data.build import build_train_loader as jax_build_train_loader
from dvis_plus_tpu.data.build import mapper_for_type as jax_mapper_for_type
from dvis_plus_tpu.data.datasets import vps_vss as jax_vps_vss
from dvis_plus_tpu.data.datasets.categories import YTVIS_2019_CLASSES
from dvis_plus_tpu.data.datasets.ytvis import register_all_ytvis as jax_register_all_ytvis
from dvis_plus_tpu_torch import cli
from dvis_plus_tpu_torch.config import load_config
from dvis_plus_tpu_torch.core import checkpoint as ckpt
from dvis_plus_tpu_torch.data import catalog
from dvis_plus_tpu_torch.data.build import build_combined_train_loader
from dvis_plus_tpu_torch.data.datasets import vps_vss
from dvis_plus_tpu_torch.data.datasets.ytvis import register_all_ytvis
from dvis_plus_tpu_torch.data.mapper import mapper_for_type
from tests.test_torch_common import DAQ_TINY

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from synth_data import make_vipseg, make_vspw, make_ytvis  # noqa: E402

torch.set_num_threads(2)
DATA = ["input.sampling_frame_num=3", "input.min_size_train=[48,64]", "input.max_size_train=96",
        "model.criterion.max_num_instances=4", "solver.ims_per_batch=2"]
SETS = {
    "vps": ("configs/dvis/minvis_r50_vipseg.yaml", "panoVSPW_vps_video_train", "video_panoptic",
            ["model.num_classes=3"]),
    "vss": ("configs/dvis/minvis_r50_vspw.yaml", "VSPW_vss_video_train", "video_semantic", []),
    "sot": ("configs/daq/daq_vos_vitl_mose_online.yaml", "ytvis_2019_train", "video_sot", []),
}


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vps_vss_train_synth"))
    make_vipseg(root, n_videos=3, length=5)
    make_vspw(root, n_videos=3, length=5, H=48, W=90)
    make_ytvis(root, "ytvis_2019", YTVIS_2019_CLASSES, splits=("train",), n_videos=3, length=5)
    for reg in (vps_vss.register_all_vipseg, vps_vss.register_all_vspw, register_all_ytvis,
                jax_vps_vss.register_all_vipseg, jax_vps_vss.register_all_vspw, jax_register_all_ytvis):
        reg(root)
    return root


def _cfgs(task, extra=()):
    yaml, name, dtype, opts = SETS[task]
    opts = [*DATA, *opts, f"datasets.train=[{name}]", f"datasets.dataset_type=[{dtype}]", *extra]
    return load_config(yaml, opts), jax_load_config(yaml, opts), name, dtype


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "meta":
            for a, b in zip(got[k], want[k]):
                assert sorted(a) == sorted(b) and all(np.array_equal(a[j], b[j]) for j in a)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("task", sorted(SETS))
def test_training_mapper_equals_jax(synth_root, task):
    """Every training clip of every video under four clip seeds, the
    panoptic classes from the set's registered categories."""
    cfg, jcfg, name, dtype = _cfgs(task)
    got_map = mapper_for_type(cfg, dtype, is_train=True, dataset_name=name)
    want_map = jax_mapper_for_type(jcfg, dtype, True, dataset_name=name)
    labels = set()
    for rec in catalog.get_dataset(name):
        for seed in range(4):
            got, want = got_map(rec, seed=seed), want_map(rec, seed=seed)
            _equal(got, want)
            assert got["masks"].shape == (4, 3, 64, 96) and got["valid"].any()
            labels |= set(got["labels"][got["valid"]].tolist())
    assert labels == {"sot": {0}, "vps": {0, 2}, "vss": {0, 1}}[task]


@pytest.mark.parametrize("categories", [None, [{"id": 0, "isthing": 1}, {"id": 2, "isthing": 1},
                                               {"id": 1, "isthing": 0}]], ids=["dataset-ids", "things-first"])
def test_panoptic_mapper_maps_classes_as_jax(synth_root, categories):
    """Without categories the dataset ids pass through; with a list whose
    sorted things and stuff renumber them (2 -> 1), the classes follow it."""
    cfg, jcfg, name, _ = _cfgs("vps")
    got_map = vps_vss.PanopticVideoMapper(cfg, categories=categories)
    want_map = jax_vps_vss.PanopticVideoMapper(jcfg, is_train=True, categories=categories)
    for rec in catalog.get_dataset(name):
        got, want = got_map(rec, seed=3), want_map(rec, seed=3)
        _equal(got, want)
    assert set(got["labels"][got["valid"]].tolist()) == ({0, 2} if categories is None else {0, 1})


@pytest.mark.parametrize("task", sorted(SETS))
def test_loader_batches_equal_jax(synth_root, task):
    cfg, jcfg, name, dtype = _cfgs(task, ["input.sampling_frame_range=1"])
    want = jax_build_train_loader(jcfg, name, jax_mapper_for_type(jcfg, dtype, True, dataset_name=name),
                                  seed=5, num_workers=1)
    got = build_combined_train_loader(cfg, seed=5, num_workers=2)
    for _ in range(3):
        g, w = next(got), next(want)
        assert g["images"].shape == (2, 3, 64, 96, 3)
        _equal(g, w)


def _train(out, extra=(), resume=False):
    opts = [*DAQ_TINY, "model.num_classes=3", "model.criterion.train_num_points=64",
            "input.sampling_frame_num=3", "input.sampling_frame_range=1", "solver.ims_per_batch=2",
            "model.daq.using_frame_num=[2]", "model.daq.steps=[2]", "model.daq.increasing_step=[2]",
            "solver.checkpoint_period=2", *extra, f"output_dir={out}"]
    return cli.main(["--config-file", "configs/daq/daq_online_r50_vipseg.yaml", "--device", "cpu",
                     *(["--resume"] if resume else []), *opts])


def test_cli_trains_daq_on_vipseg_and_resumes_to_the_unbroken_run(synth_root, monkeypatch, tmp_path):
    """Three steps (two in stage 2, one in stage 3), every batch cut by the
    curriculum; a run stopped after step 2 and resumed ends bit-equal to the
    unbroken one (the curriculum's generator taken up where it was)."""
    monkeypatch.setenv("DVIS_DATASETS", synth_root)
    whole, broken = tmp_path / "whole", tmp_path / "broken"
    assert _train(whole, ["solver.max_iter=3"]) == {"step": 3, "device": "cpu"}
    line = (whole / "metrics.jsonl").read_text().splitlines()[0]
    assert '"slot_loss_ce"' in line and '"loss_dice_0"' in line
    assert sorted(os.listdir(whole / "checkpoints")) == ["step_0000002.pth", "step_0000003.pth"]
    _train(broken, ["solver.max_iter=2"])
    assert _train(broken, ["solver.max_iter=3"], resume=True) == {"step": 3, "device": "cpu"}
    a, b = (ckpt.restore(str(d / "checkpoints" / "step_0000003.pth")) for d in (whole, broken))
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for k in a["optimizer"]["mu"]:
        assert torch.equal(a["optimizer"]["mu"][k], b["optimizer"]["mu"][k]), k
    start = ckpt.restore(str(whole / "checkpoints" / "step_0000002.pth"))["model"]
    assert any(not torch.equal(start[k], a["model"][k]) for k in a["model"] if k.startswith("tracker."))
    assert all(torch.equal(start[k], a["model"][k]) for k in a["model"] if not k.startswith("tracker."))
