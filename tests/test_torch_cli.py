"""The port's own host-side modules behind its CLI (dataset catalog, YouTube-VIS
registration, eval mapper, VIS scorer, RLE area / merge) against the JAX
package's on the synthetic YouTube-VIS set of ``tools/synth_data.py``, the
CLI's ``--device`` rule, and one CLI run on the CPU with the tiny ViT-Adapter
model. Host code is integer or decoded-image work: equal arrays, equal AP."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from dvis_plus_tpu.core.config import load_config as jax_load_config
from dvis_plus_tpu.data import catalog as jax_catalog
from dvis_plus_tpu.data.build import mapper_for_type
from dvis_plus_tpu.data.datasets.categories import YTVIS_2019_CLASSES
from dvis_plus_tpu.data.datasets.ytvis import register_all_ytvis as jax_register_all_ytvis
from dvis_plus_tpu.evaluation.ytvos_eval import evaluate_vis as jax_evaluate_vis
from dvis_plus_tpu.utils import rle as jax_rle
from dvis_plus_tpu_torch import cli
from dvis_plus_tpu_torch.config import load_config
from dvis_plus_tpu_torch.data import catalog
from dvis_plus_tpu_torch.data.datasets import categories
from dvis_plus_tpu_torch.data.datasets.ytvis import register_all_ytvis
from dvis_plus_tpu_torch.data.mapper import YTVISDatasetMapper
from dvis_plus_tpu_torch.evaluation.ytvos_eval import evaluate_vis
from dvis_plus_tpu_torch.utils import rle

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from synth_data import make_ytvis  # noqa: E402

torch.set_num_threads(2)

YAML = "configs/dvis/dvis_offline_vitl_ytvis19.yaml"
TINY = [
    "model.compute_dtype=float32",
    "model.backbone.vit_embed_dim=32", "model.backbone.vit_depth=2",
    "model.backbone.vit_num_heads=2", "model.backbone.vit_deform_num_heads=2",
    "model.backbone.vit_interaction_indexes=[[0,0],[1,1]]", "model.backbone.vit_conv_inplane=8",
    "model.pixel_decoder.conv_dim=32", "model.pixel_decoder.mask_dim=32",
    "model.pixel_decoder.transformer_enc_layers=1",
    "model.pixel_decoder.transformer_dim_feedforward=64",
    "model.transformer_decoder.hidden_dim=32", "model.transformer_decoder.num_queries=8",
    "model.transformer_decoder.nheads=4", "model.transformer_decoder.dim_feedforward=64",
    "model.transformer_decoder.dec_layers=2", "model.transformer_decoder.mask_dim=32",
    "model.transformer_decoder.reid_hidden_dim=32",
    "model.tracker.num_layers=1", "model.tracker.feedforward_dim=64",
    "model.refiner.num_layers=1", "model.refiner.feedforward_dim=64",
    "input.min_size_test=48", "input.max_size_test=80",
    "test.window_size=4", "test.max_num=5", "datasets.test=[ytvis_2019_val]",
]


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dvis_synth"))
    make_ytvis(root, "ytvis_2019", YTVIS_2019_CLASSES, n_videos=2, length=5)
    register_all_ytvis(root)
    jax_register_all_ytvis(root)
    return root


def test_category_tables_equal():
    from dvis_plus_tpu.data.datasets import categories as jax_categories

    for name in ("YTVIS_2019_CLASSES", "YTVIS_2021_CLASSES", "OVIS_CLASSES", "BDD_TRACK_CLASSES"):
        assert getattr(categories, name) == getattr(jax_categories, name), name
    assert categories.thing_dataset_id_to_contiguous_id(["a", "b"]) == {1: 0, 2: 1}


def test_catalog_and_registration_equal(synth_root):
    # other tests of the same process may have registered further JAX-side
    # sets, and the CLI registers the VIPSeg, VSPW and COCO sets (with the
    # ADE20k and Mapillary panoptic ones) beside these
    names = [n for n in catalog.list_datasets()
             if not n.startswith(("panoVSPW_", "VSPW_", "coco", "ade20k_", "mapillary_"))]
    assert len(names) == 20 and set(names) <= set(jax_catalog.list_datasets())
    for name in names:
        assert vars(catalog.get_metadata(name)) == vars(jax_catalog.get_metadata(name)), name
    assert catalog.get_dataset("ytvis_2019_val") == jax_catalog.get_dataset("ytvis_2019_val")
    assert catalog.is_registered("ytvis_2019_val") and not catalog.is_registered("nope")
    with pytest.raises(KeyError):
        catalog.get_dataset("nope")


def test_eval_mapper_equals_jax(synth_root):
    """48-pixel shorter edge from 64x96 frames: cv2 resizes, and the 48x72
    result pads to 64x96 (divisibility 32)."""
    want_map = mapper_for_type(jax_load_config(YAML, TINY), "video_instance", False,
                               dataset_name="ytvis_2019_val")
    got_map = YTVISDatasetMapper(load_config(YAML, TINY))
    for rec in catalog.get_dataset("ytvis_2019_val"):
        got, want = got_map(rec, seed=0), want_map(rec, seed=0)
        assert sorted(got) == sorted(want)
        assert got["images"].shape == (5, 64, 96, 3) and list(got["image_size"]) == [48, 72]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    frames = [np.full((40, 60, 3), i, np.uint8) for i in range(2)]
    rec = {"_frames": frames, "length": 2, "file_names": ["a", "b"]}
    np.testing.assert_array_equal(got_map(rec)["images"], want_map(rec)["images"])


def _random_tracks(rng, n, T, H, W, with_score):
    rows = []
    for i in range(n):
        y, x = rng.randint(0, H - 8), rng.randint(0, W - 8)
        segs = []
        for t in range(T):
            if rng.rand() < 0.2:
                segs.append(None)
                continue
            m = np.zeros((H, W), np.uint8)
            m[y : y + rng.randint(3, 8), x + t : x + t + rng.randint(3, 8)] = 1
            e = rle.encode(m)
            segs.append({"size": e["size"], "counts": e["counts"].decode("ascii")})
        row = {"video_id": 1 + i % 2, "category_id": 1 + rng.randint(3), "segmentations": segs,
               "iscrowd": int(rng.rand() < 0.15), "id": i}
        if with_score:
            row["score"] = float(rng.rand())
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_vis_equals_jax(seed):
    rng = np.random.RandomState(seed)
    gt = _random_tracks(rng, 8, 4, 24, 32, False)
    dt = gt[:4] + _random_tracks(rng, 10, 4, 24, 32, True)
    for d in dt:
        d.setdefault("score", 0.9)
    got = evaluate_vis(gt, dt, {1: 4, 2: 4})
    want = jax_evaluate_vis(gt, dt, {1: 4, 2: 4})
    assert got == want and got["AP"] > 0.0


def test_rle_area_and_merge_equal_jax():
    rng = np.random.RandomState(2)
    a, b = (rng.rand(17, 23) < 0.4).astype(np.uint8), (rng.rand(17, 23) < 0.4).astype(np.uint8)
    ra, rb = rle.encode(a), rle.encode(b)
    assert rle.area(ra) == jax_rle.area(ra) == int(a.sum())
    for intersect in (True, False):
        got, want = rle.merge([ra, rb], intersect), jax_rle.merge([ra, rb], intersect)
        assert got["size"] == list(want["size"]) and got["counts"] == want["counts"]
    np.testing.assert_array_equal(rle.decode(rle.merge([ra, rb], True)), a & b)


def test_cli_cuda_without_a_card_raises(monkeypatch, tmp_path):
    """The CLI runs on the card unless asked otherwise: with the default
    ``--device cuda`` and no card it raises and never falls to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["--config-file", YAML, "--eval-only", *extra, *TINY,
                      f"output_dir={tmp_path}"])
    assert not os.path.exists(tmp_path / "inference")


def test_cli_on_cpu_writes_scored_rows(synth_root, monkeypatch, tmp_path):
    monkeypatch.setenv("DVIS_DATASETS", synth_root)
    out = cli.main(["--config-file", YAML, "--eval-only", "--device", "cpu", *TINY,
                    f"output_dir={tmp_path}"])
    res = out["ytvis_2019_val"]
    assert res["device"] == "cpu" and res["predictions"] == 10  # 2 videos x top-5
    assert {"AP", "AP50", "AP75", "AR100"} <= set(res)
    with open(res["results_json"]) as f:
        rows = json.load(f)
    assert len(rows) == 10 and all(len(r["segmentations"]) == 5 for r in rows)
    assert all(s is None or s["size"] == [64, 96] for r in rows for s in r["segmentations"])
