"""The port's training host side and entry point: the loader against the JAX
package's (``data/build.py::build_train_loader``) on a ``make_ytvis`` set,
bit for bit; the loader started part-way equal to the tail of an unbroken
one; ``python -m dvis_plus_tpu_torch.cli`` without ``--eval-only`` training
a tiny DVIS++ online, CTVIS and DVIS++ offline on the CPU, writing
``metrics.jsonl`` and checkpoints, and resuming to the unbroken run's
weights, optimizer state and class memory; the card
asked for and absent raises; and ``weights=`` loading a ``.npz`` and a
``.pth`` wrapped in ``module`` with a 41-class head (the rest loads equal,
the heads keep their initialization and are logged by name)."""
import logging
import os
import sys

import numpy as np
import pytest
import torch

from dvis_plus_tpu.core.config import load_config as jax_load_config
from dvis_plus_tpu.data.build import build_train_loader as jax_build_train_loader
from dvis_plus_tpu.data.datasets.categories import YTVIS_2019_CLASSES
from dvis_plus_tpu.data.datasets.ytvis import register_all_ytvis as jax_register_all_ytvis
from dvis_plus_tpu_torch import cli
from dvis_plus_tpu_torch.config import TINY_TRAIN, load_config
from dvis_plus_tpu_torch.core import checkpoint as ckpt
from dvis_plus_tpu_torch.data.build import build_combined_train_loader, build_train_loader
from dvis_plus_tpu_torch.data.datasets.ytvis import register_all_ytvis

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from synth_data import make_ytvis  # noqa: E402

torch.set_num_threads(2)
YAML = "configs/dvis/dvis_online_r50_ytvis19.yaml"
DATA = ["input.sampling_frame_num=3", "input.min_size_train=[48,64]", "input.max_size_train=96",
        "model.criterion.max_num_instances=3", "solver.ims_per_batch=2"]
TRAIN_TINY = [*TINY_TRAIN, "model.tracker.matcher_solver=jv", "model.criterion.train_num_points=64",
              "solver.max_iter=4", "solver.checkpoint_period=2", *DATA]


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dvis_synth_train"))
    make_ytvis(root, "ytvis_2019", YTVIS_2019_CLASSES, n_videos=3, length=6)
    register_all_ytvis(root)
    jax_register_all_ytvis(root)
    return root


@pytest.mark.parametrize("extra", [["input.sampling_frame_range=1"],
                                   ["input.sampling_frame_range=2", "input.crop_enabled=true"]],
                         ids=["window", "reference_frame_and_crop"])
def test_loader_batches_equal_jax(synth_root, extra):
    """A contiguous window reversed half the time, or a reference frame and
    two within 2 of it with the relative crop; shorter edge 48 or 64 on the
    64x96 canvas. One JAX worker: its threads hand clips over as they finish."""
    want = jax_build_train_loader(jax_load_config(YAML, DATA + extra), "ytvis_2019_train", seed=5,
                                  num_workers=1)
    got = build_train_loader(load_config(YAML, DATA + extra), "ytvis_2019_train", seed=5, num_workers=3)
    for _ in range(4):
        g, w = next(got), next(want)
        assert g["images"].shape == (2, 3, 64, 96, 3) and g["masks"].shape == (2, 3, 3, 64, 96)
        for k in ("images", "labels", "masks", "valid", "frame_valid"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for a, b in zip(g["meta"], w["meta"]):
            assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    assert w["valid"].any()


def test_loader_started_part_way_equals_the_unbroken_tail(synth_root):
    cfg = load_config(YAML, DATA + ["datasets.train=[ytvis_2019_train,ytvis_2019_train]",
                                    "datasets.dataset_ratio=[1.0,3.0]"])
    whole = build_combined_train_loader(cfg, seed=2, num_workers=0)
    batches = [next(whole) for _ in range(5)]
    tail = build_combined_train_loader(cfg, seed=2, start_batches=3, num_workers=2)
    for want in batches[3:]:
        got = next(tail)
        assert got["dataset_index"] == want["dataset_index"]
        np.testing.assert_array_equal(got["images"], want["images"])
    single = build_combined_train_loader(load_config(YAML, DATA), seed=2, num_workers=0)
    first = [next(single) for _ in range(3)]
    np.testing.assert_array_equal(
        next(build_combined_train_loader(load_config(YAML, DATA), seed=2, start_batches=2))["masks"],
        first[2]["masks"])


def _train(out, extra=(), resume=False, yaml=YAML):
    return cli.main(["--config-file", yaml, "--device", "cpu", *(["--resume"] if resume else []),
                     *TRAIN_TINY, *extra, f"output_dir={out}"])


def test_cli_trains_checkpoints_and_resumes_to_the_unbroken_run(synth_root, monkeypatch, tmp_path):
    monkeypatch.setenv("DVIS_DATASETS", synth_root)
    whole, broken = tmp_path / "whole", tmp_path / "broken"
    assert _train(whole) == {"step": 4, "device": "cpu"}
    lines = (whole / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and '"total_loss"' in lines[0] and '"loss_reid"' in lines[0]
    assert sorted(os.listdir(whole / "checkpoints")) == ["step_0000002.pth", "step_0000004.pth"]
    # stop after step 2: the run's checkpoint of step 4 is gone, then resume
    _train(broken)
    os.remove(broken / "checkpoints" / "step_0000004.pth")
    assert _train(broken, resume=True) == {"step": 4, "device": "cpu"}
    a, b = (ckpt.restore(str(d / "checkpoints" / "step_0000004.pth")) for d in (whole, broken))
    assert a["step"] == b["step"] == 4 and a["optimizer"]["count"] == b["optimizer"]["count"] == 4
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for k in a["optimizer"]["mu"]:
        assert torch.equal(a["optimizer"]["mu"][k], b["optimizer"]["mu"][k]), k
        assert torch.equal(a["optimizer"]["nu"][k], b["optimizer"]["nu"][k]), k
    start = ckpt.restore(str(whole / "checkpoints" / "step_0000002.pth"))["model"]
    assert any(not torch.equal(start[k], a["model"][k]) for k in a["model"] if k.startswith("tracker."))
    assert all(torch.equal(start[k], a["model"][k]) for k in a["model"] if not k.startswith("tracker."))


@pytest.mark.parametrize("arch", ["ctvis", "dvis_offline"])
def test_cli_trains_stages_1_and_3_and_resumes_to_the_unbroken_run(arch, synth_root, monkeypatch,
                                                                   tmp_path):
    """CTVIS (stage 1: the whole segmenter, the contrastive tracking loss)
    and DVIS++ offline (stage 3: the refiner, its class memory) through the
    CLI; a run broken after step 2 and resumed ends bit-equal to the
    unbroken one, the class memory included."""
    monkeypatch.setenv("DVIS_DATASETS", synth_root)
    yaml = f"configs/dvis/{arch}_r50_ytvis19.yaml"
    whole, broken = tmp_path / "whole", tmp_path / "broken"
    assert _train(whole, yaml=yaml) == {"step": 4, "device": "cpu"}
    lines = (whole / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and '"loss_reid"' in lines[0] and '"loss_dice_0"' in lines[0]
    _train(broken, yaml=yaml)
    os.remove(broken / "checkpoints" / "step_0000004.pth")
    assert _train(broken, resume=True, yaml=yaml) == {"step": 4, "device": "cpu"}
    a, b = (ckpt.restore(str(d / "checkpoints" / "step_0000004.pth")) for d in (whole, broken))
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for k in a["optimizer"]["mu"]:
        assert torch.equal(a["optimizer"]["mu"][k], b["optimizer"]["mu"][k]), k
    start = ckpt.restore(str(whole / "checkpoints" / "step_0000002.pth"))
    trained = "refiner." if arch == "dvis_offline" else "backbone."
    assert any(not torch.equal(start["model"][k], a["model"][k]) for k in a["model"] if k.startswith(trained))
    if arch == "dvis_offline":
        assert all(torch.equal(start["model"][k], a["model"][k]) for k in a["model"]
                   if not k.startswith("refiner."))
        assert int(a["memory"]["count"].sum()) > int(start["memory"]["count"].sum()) > 0
        for k in ("embeds", "count"):
            assert torch.equal(a["memory"][k], b["memory"][k]), k
    else:
        assert a["memory"] is None and b["memory"] is None


def test_training_refuses_an_unported_setting_and_a_missing_card(monkeypatch, tmp_path):
    with pytest.raises(NotImplementedError, match=r"model\.meta_architecture='minvis_ov'.*A14c"):
        _train(tmp_path, ["model.meta_architecture=minvis_ov"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--config-file", YAML, *TRAIN_TINY, f"output_dir={tmp_path}"])
    assert not os.path.exists(tmp_path / "checkpoints")


@pytest.mark.parametrize("kind", ["npz", "pth_module"])
def test_weights_with_another_class_count_load_the_rest(kind, tmp_path, caplog):
    """A checkpoint of a 41-class model into a 40-class one: every key but the
    two class heads loads; the heads keep the module's initialization."""
    cfg = load_config(YAML, TRAIN_TINY)
    torch.manual_seed(0)
    src_cfg = load_config(YAML, TRAIN_TINY + ["model.num_classes=41"])
    src = cli.build_model(src_cfg.model).state_dict()
    torch.manual_seed(1)
    model = cli.build_model(cfg.model)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    path = tmp_path / ("w.npz" if kind == "npz" else "w.pth")
    if kind == "npz":
        np.savez(path, **{k: v.numpy() for k, v in src.items()})
    else:
        torch.save({"module": src}, path)
    with caplog.at_level(logging.WARNING):
        skipped = ckpt.load_weights(model, str(path))
    heads = ["sem_seg_head.predictor.class_embed.bias", "sem_seg_head.predictor.class_embed.weight",
             "tracker.class_embed.bias", "tracker.class_embed.weight"]
    assert skipped == {"missing": [], "unexpected": [], "mismatched": heads}
    got = model.state_dict()
    for k in got:
        assert torch.equal(got[k], init[k] if k in heads else src[k]), k
    assert all(h in caplog.text for h in heads)
