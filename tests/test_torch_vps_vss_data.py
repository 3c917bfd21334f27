"""The port's VIPSeg and VSPW host code against the JAX package's
(``dvis_plus_tpu/data/datasets/vps_vss.py``, ``data/build.py::mapper_for_type``)
on the synthetic trees of ``tools/synth_data.py`` (``make_vipseg``,
``make_vspw``): the loaders' records, the registered metadata, the
things-first contiguous maps and ``vspw_preprocess`` are equal, and the eval
mapper's arrays equal the JAX eval mapper's exactly (the JAX panoptic and
semantic mappers also decode the ground-truth masks, which no inference
reads; the arrays the inference reads are the same)."""
import os
import sys

import numpy as np
import pytest

from dvis_plus_tpu.core.config import load_config as jax_load_config
from dvis_plus_tpu.data import catalog as jax_catalog
from dvis_plus_tpu.data.build import mapper_for_type as jax_mapper_for_type
from dvis_plus_tpu.data.datasets import vps_vss as jax_vps_vss
from dvis_plus_tpu_torch.config import load_config
from dvis_plus_tpu_torch.data import catalog
from dvis_plus_tpu_torch.data.datasets import vps_vss
from dvis_plus_tpu_torch.data.mapper import mapper_for_type

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from synth_data import make_vipseg, make_vspw  # noqa: E402

SETS = {"vps": ("configs/dvis/dvis_online_r50_vipseg.yaml", "panoVSPW_vps_video_val", "video_panoptic"),
        "vss": ("configs/dvis/dvis_offline_r50_vspw.yaml", "VSPW_vss_video_val", "video_semantic")}
TINY = ["input.min_size_test=48", "input.max_size_test=80"]


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vps_vss_synth"))
    make_vipseg(root, n_videos=2, length=3)
    make_vspw(root, n_videos=2, length=3, H=48, W=90)
    for reg in (vps_vss.register_all_vipseg, vps_vss.register_all_vspw,
                jax_vps_vss.register_all_vipseg, jax_vps_vss.register_all_vspw):
        reg(root)
    return root


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("prefix", ["panoVSPW_vps_video_", "VSPW_vss_video_"])
def test_registration_and_records_equal(synth_root, prefix, split):
    """(The synthetic VIPSeg tree has no test json: both loaders raise.)"""
    name = prefix + split
    assert vars(catalog.get_metadata(name)) == vars(jax_catalog.get_metadata(name))
    if prefix.startswith("pano") and split == "test":
        for cat in (catalog, jax_catalog):
            with pytest.raises(FileNotFoundError):
                cat.get_dataset(name)
        return
    got, want = catalog.get_dataset(name), jax_catalog.get_dataset(name)
    assert got == want and len(got) == 2


def test_vipseg_metadata_holds_the_categories(synth_root):
    md = catalog.get_metadata("panoVSPW_vps_video_val")
    assert [c["id"] for c in md.categories] == [0, 1, 2]
    assert md.thing_classes == ["person", "car"] and md.stuff_classes == ["sky"]
    rec = catalog.get_dataset("panoVSPW_vps_video_val")[0]
    assert rec["video_id"] == "video_0001" and rec["length"] == 3
    assert rec["file_names"][0].endswith(os.path.join("images", "video_0001", "00000.jpg"))


def test_vspw_split_reads_its_own_list(synth_root):
    """Each split reads its own ``<split>.txt`` (the JAX loader reads
    ``test.txt`` for all three; the synthetic lists are equal, so the records
    above agree)."""
    base = os.path.join(synth_root, "VSPW_480p")
    with open(os.path.join(base, "val.txt"), "w") as f:
        f.write("video_0002\n")
    try:
        assert [r["video_id"] for r in catalog.get_dataset("VSPW_vss_video_val")] == ["video_0002"]
        assert [r["video_id"] for r in catalog.get_dataset("VSPW_vss_video_test")] == [
            "video_0001", "video_0002"]
    finally:
        with open(os.path.join(base, "val.txt"), "w") as f:
            f.write("video_0001\nvideo_0002\n")


@pytest.mark.parametrize("categories", [
    [{"id": 0, "isthing": 1}, {"id": 1, "isthing": 1}, {"id": 2, "isthing": 0}],
    [{"id": 7, "isthing": 0}, {"id": 3, "isthing": 1}, {"id": 12, "isthing": 0}, {"id": 1, "isthing": 1},
     {"id": 5}],
])
def test_contiguous_maps_equal(categories):
    got = vps_vss.panoptic_contiguous_maps(categories)
    assert got == jax_vps_vss.panoptic_contiguous_maps(categories)
    d2c, c2d, n_things = got
    assert n_things == sum(bool(c.get("isthing")) for c in categories)
    assert sorted(c2d) == list(range(len(categories)))


def test_vspw_preprocess_and_panoptic_decode_equal():
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, (3, 17, 23)).astype(np.uint8)
    raw[0, 0, :3] = (0, 1, 255)
    got = vps_vss.vspw_preprocess(raw)
    np.testing.assert_array_equal(got, jax_vps_vss.SemanticVideoMapper.vspw_preprocess(raw))
    assert got[0, 0, :3].tolist() == [255, 0, 255]
    rgb = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    np.testing.assert_array_equal(vps_vss.decode_panoptic_png(rgb), jax_vps_vss.decode_panoptic_png(rgb))


@pytest.mark.parametrize("task", sorted(SETS))
def test_eval_mapper_equals_jax(synth_root, task):
    """VIPSeg frames are 64x96 with a size in the record, VSPW's 48x90 with
    none (the mapper takes the first frame's); a 48-pixel shorter edge,
    padded to a multiple of 32."""
    yaml, name, dtype = SETS[task]
    want_map = jax_mapper_for_type(jax_load_config(yaml, TINY), dtype, False, dataset_name=name)
    got_map = mapper_for_type(load_config(yaml, TINY), dtype)
    for rec in catalog.get_dataset(name):
        got, want = got_map(rec, seed=0), want_map(rec, seed=0)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert isinstance(got["video_id"], str) and got["images"].shape[0] == 3
        assert (got["height"], got["width"]) == ((64, 96) if task == "vps" else (48, 90))


@pytest.mark.parametrize("dataset_type,item", [("image_semantic", "image_semantic"),
                                               ("video_unknown", "video_unknown")])
def test_mapper_refuses_unported_types(dataset_type, item):
    with pytest.raises(NotImplementedError, match=item):
        mapper_for_type(load_config(None), dataset_type)


@pytest.mark.parametrize("dataset_type,item", [("panoptic", "panoptic"), ("video_unknown", "video_unknown"),
                                               ("image_semantic", "image_semantic")])
def test_training_mapper_refuses_unported_types(dataset_type, item):
    """Types no package knows; the panoptic, semantic and object sets train
    (``tests/test_torch_vps_vss_train.py``), ``image_instance`` and
    ``image_panoptic`` too (``tests/test_torch_pseudo_video.py``,
    ``tests/test_torch_ov_data.py``)."""
    with pytest.raises(NotImplementedError, match=item):
        mapper_for_type(load_config(None), dataset_type, is_train=True)
