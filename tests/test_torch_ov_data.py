"""The open-vocabulary recipes' COCO panoptic pseudo-videos against the JAX
package, bit for bit: ``load_coco_panoptic`` (with and without the json's
``images`` list) and the panoptic sets of ``register_all_coco``;
``CocoPanopticPseudoVideoMapper`` in training (with and without LSJ and the
colour jitter) and at eval on ``tools/synth_data.py::make_coco``, one of
whose segments is marked crowd (it is dropped); the training loader of
``coco_panoptic_video_ov``; and the eval loader of an ``image_panoptic``
test set, which the JAX package's ``build_test_loader`` sends through the
same mapper (so ``config.SUPPORTED`` accepts the type)."""
import json
import os
import sys

import numpy as np
import pytest

from dvis_plus_tpu.core.config import load_config as jax_load_config
from dvis_plus_tpu.data.build import build_test_loader as jax_build_test_loader
from dvis_plus_tpu.data.build import build_train_loader as jax_build_train_loader
from dvis_plus_tpu.data.build import mapper_for_type as jax_mapper_for_type
from dvis_plus_tpu.data.catalog import get_dataset as jax_get_dataset
from dvis_plus_tpu.data.catalog import get_metadata as jax_get_metadata
from dvis_plus_tpu.data.datasets.coco import load_coco_panoptic as jax_load_coco_panoptic
from dvis_plus_tpu.data.datasets.coco import register_all_coco as jax_register_all_coco
from dvis_plus_tpu_torch.config import check_supported, load_config
from dvis_plus_tpu_torch.data.build import build_combined_train_loader
from dvis_plus_tpu_torch.data.catalog import get_dataset, get_metadata
from dvis_plus_tpu_torch.data.datasets.coco import load_coco_panoptic, register_all_coco
from dvis_plus_tpu_torch.data.mapper import mapper_for_type
from dvis_plus_tpu_torch.data.pseudo_video import CocoPanopticPseudoVideoMapper

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from synth_data import make_coco  # noqa: E402

YAML = "configs/ov/ov_online_convnextl_coco.yaml"
FCCLIP = "configs/ov/fcclip_convnextl_coco.yaml"
SMALL = ["input.min_size_train=[48,64]", "input.max_size_train=96", "model.criterion.max_num_instances=4",
         "solver.ims_per_batch=2", "input.min_size_test=48", "input.max_size_test=80",
         "input.sampling_frame_num=2"]
JITTER = ["input.lsj_aug=true", "input.augmentations=[brightness,contrast,saturation]"]
PANOPTIC_SETS = ("coco_2017_train_panoptic", "coco_panoptic_video_ov", "coco_2017_val_panoptic",
                 "ade20k_panoptic_train", "mapillary_vistas_panoptic_train")
CROWD = 4  # the segment id marked crowd: image 2's first box


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """``make_coco``'s five images (two boxes and a stuff background each:
    things person and car, stuff sky), with segment :data:`CROWD` crowd."""
    root = str(tmp_path_factory.mktemp("dvis_synth_coco_panoptic"))
    make_coco(root, n_images=5, H=64, W=96)
    jf = os.path.join(root, "coco", "annotations", "panoptic_train2017.json")
    with open(jf) as f:
        data = json.load(f)
    for a in data["annotations"]:
        for s in a["segments_info"]:
            s["iscrowd"] = int(s["id"] == CROWD)
    with open(jf, "w") as f:
        json.dump(data, f)
    register_all_coco(root)
    jax_register_all_coco(root)
    return root


def _assert_clips_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_panoptic_loader_and_sets_equal_jax(coco_root, tmp_path):
    """The records of every panoptic set the two packages register (the
    COCO val, ADE20k and Mapillary sets have no files here: the same names,
    the same failure), their metadata, and the loader on a json without ``images``
    (each image named as its PNG, size 0)."""
    coco = os.path.join(coco_root, "coco")
    jf = os.path.join(coco, "annotations", "panoptic_train2017.json")
    args = (jf, os.path.join(coco, "train2017"), os.path.join(coco, "panoptic_train2017"))
    recs = load_coco_panoptic(*args)
    assert recs == jax_load_coco_panoptic(*args) and len(recs) == 5
    assert [s["isthing"] for s in recs[0]["segments_infos"][0]] == [1, 1, 0]
    for name in PANOPTIC_SETS[:2]:
        assert get_dataset(name) == jax_get_dataset(name), name
        md, jmd = get_metadata(name), jax_get_metadata(name)
        assert {k: v for k, v in vars(md).items()} == {k: v for k, v in vars(jmd).items()}, name
    for name in PANOPTIC_SETS[2:]:
        with pytest.raises(FileNotFoundError):
            get_dataset(name)
        with pytest.raises(FileNotFoundError):
            jax_get_dataset(name)
    with open(jf) as f:
        data = json.load(f)
    del data["images"]
    bare = str(tmp_path / "panoptic_no_images.json")
    with open(bare, "w") as f:
        json.dump(data, f)
    recs = load_coco_panoptic(bare, *args[1:])
    assert recs == jax_load_coco_panoptic(bare, *args[1:])
    assert {(r["height"], r["width"]) for r in recs} == {(0, 0)}


@pytest.mark.parametrize("yaml,extra,is_train", [
    (YAML, [], True), (YAML, JITTER, True), (FCCLIP, [], True), (YAML, [], False)],
    ids=["clip_train", "clip_train_lsj_colour", "fcclip_train", "clip_eval"])
def test_panoptic_pseudo_video_mapper_equals_jax(coco_root, yaml, extra, is_train):
    """Every record, four seeds each: every array of the JAX mapper's
    output, equal. Without LSJ's crop every non-crowd segment is a track
    of its things-first class (person 0, car 1, sky 2); the crowd one is
    dropped."""
    want_m = jax_mapper_for_type(jax_load_config(yaml, SMALL + extra), "image_panoptic", is_train,
                                 dataset_name="coco_panoptic_video_ov")
    got_m = mapper_for_type(load_config(yaml, SMALL + extra), "image_panoptic", is_train,
                            dataset_name="coco_panoptic_video_ov")
    assert isinstance(got_m, CocoPanopticPseudoVideoMapper)
    for rec in get_dataset("coco_panoptic_video_ov"):
        for seed in range(4):
            got = got_m(rec, seed=seed)
            _assert_clips_equal(got, want_m(rec, seed=seed))
            if is_train and not extra:  # (LSJ crops may cut a segment out)
                crowd = any(s["id"] == CROWD for s in rec["segments_infos"][0])
                labels = got["labels"][got["valid"]]
                assert sorted(labels.tolist()) == ([1, 2] if crowd else [0, 1, 2])


def test_panoptic_mapper_takes_the_png_size(coco_root, tmp_path):
    """A record without its size (a json without ``images``) gives the clip
    of the one with it: the mapper reads the size from the PNG."""
    cfg = load_config(YAML, SMALL)
    mapper = mapper_for_type(cfg, "image_panoptic", True, dataset_name="coco_panoptic_video_ov")
    rec = get_dataset("coco_panoptic_video_ov")[0]
    bare = dict(rec, height=0, width=0)
    _assert_clips_equal(mapper(bare, seed=3), mapper(rec, seed=3))
    want_m = jax_mapper_for_type(jax_load_config(YAML, SMALL), "image_panoptic", True,
                                 dataset_name="coco_panoptic_video_ov")
    _assert_clips_equal(mapper(bare, seed=3), want_m(bare, seed=3))


def test_training_loader_equals_jax(coco_root):
    """The ``coco_panoptic_video_ov`` training loader: the JAX loader's
    batches (one JAX worker, so its clips come in order)."""
    jcfg = jax_load_config(YAML, SMALL)
    jmapper = jax_mapper_for_type(jcfg, "image_panoptic", True, dataset_name="coco_panoptic_video_ov")
    want = jax_build_train_loader(jcfg, "coco_panoptic_video_ov", mapper=jmapper, seed=6, num_workers=1)
    got = build_combined_train_loader(load_config(YAML, SMALL), seed=6, num_workers=2)
    for _ in range(3):
        w, g = next(want), next(got)
        for k in ("images", "labels", "masks", "valid", "frame_valid"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_eval_loader_reaches_the_panoptic_mapper(coco_root):
    """``datasets.dataset_type_test: [image_panoptic]``: the JAX test loader
    maps the set through the panoptic pseudo-video mapper (seed 0), and so
    does the port's eval mapper; ``check_supported`` accepts the type."""
    opts = SMALL + ["datasets.test=[coco_panoptic_video_ov]", "datasets.dataset_type_test=[image_panoptic]"]
    cfg = load_config(YAML, opts)
    check_supported(cfg)
    want = jax_build_test_loader(jax_load_config(YAML, opts), "coco_panoptic_video_ov")
    mapper = mapper_for_type(cfg, "image_panoptic", dataset_name="coco_panoptic_video_ov")
    assert isinstance(mapper, CocoPanopticPseudoVideoMapper)
    for rec in get_dataset("coco_panoptic_video_ov"):
        _assert_clips_equal(mapper(rec, seed=0), next(want))
