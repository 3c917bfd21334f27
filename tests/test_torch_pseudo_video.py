"""The COCO pseudo-video recipe's host side against the JAX package, bit for
bit: the rotation, large-scale-jitter and colour augmentations drawn from
the same ``random.Random`` and applied with the same cv2 calls; the COCO
instance loader and its pseudo-video splits; ``CocoPseudoVideoMapper`` in
training (with and without LSJ and the colour jitter) and at eval on
``tools/synth_data.py::make_coco``; and the training loader of an
``image_instance`` set with ``datasets.dataset_need_map`` on, which changes
no batch in either package (the JAX video mapper stores the map it is
handed and reads it nowhere, ``dvis_plus_tpu/data/mapper.py:93``)."""
import os
import random
import sys

import numpy as np
import pytest

from dvis_plus_tpu.core.config import load_config as jax_load_config
from dvis_plus_tpu.data import augmentation as jaug
from dvis_plus_tpu.data.build import build_train_loader as jax_build_train_loader
from dvis_plus_tpu.data.build import mapper_for_type as jax_mapper_for_type
from dvis_plus_tpu.data.catalog import get_dataset as jax_get_dataset
from dvis_plus_tpu.data.datasets.coco import load_coco_instances as jax_load_coco_instances
from dvis_plus_tpu.data.datasets.coco import register_all_coco as jax_register_all_coco
from dvis_plus_tpu_torch.config import load_config
from dvis_plus_tpu_torch.data import augmentation as paug
from dvis_plus_tpu_torch.data.build import build_combined_train_loader
from dvis_plus_tpu_torch.data.catalog import get_dataset
from dvis_plus_tpu_torch.data.datasets import categories as pcat
from dvis_plus_tpu_torch.data.datasets.coco import load_coco_instances, register_all_coco
from dvis_plus_tpu_torch.data.mapper import mapper_for_type
from dvis_plus_tpu_torch.data.pseudo_video import CocoPseudoVideoMapper

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from synth_data import make_coco  # noqa: E402

MASKFORMER = "configs/dvis/maskformer_r50_coco.yaml"
CLIP = "configs/dvis/video_maskformer_r50_coco_joint.yaml"
SMALL = ["input.min_size_train=[48,64]", "input.max_size_train=96", "model.criterion.max_num_instances=3",
         "solver.ims_per_batch=2", "input.min_size_test=48", "input.max_size_test=80"]
JITTER = ["input.lsj_aug=true", "input.augmentations=[brightness,contrast,saturation]"]


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dvis_synth_coco"))
    make_coco(root, n_images=5, H=64, W=96)
    register_all_coco(root)
    jax_register_all_coco(root)
    return root


def _image_and_mask(seed=0, h=37, w=53):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    mask = (rng.rand(h, w) > 0.6).astype(np.uint8)
    return img, mask


AUGS = {
    "rotation": lambda m: m.RandomRotation((-15, 15), prob=1.0),
    "rotation_half": lambda m: m.RandomRotation((-15, 15), prob=0.5),
    "resize_scale": lambda m: m.ResizeScaleClip(0.1, 2.0, 48, 48),
    "fixed_size_crop": lambda m: m.FixedSizeCropClip((24, 64)),
    "brightness": lambda m: m.RandomBrightness(),
    "contrast": lambda m: m.RandomContrast(),
    "saturation": lambda m: m.RandomSaturation(),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmentation_equals_jax(name):
    """Each augmentation drawn from the same ``random.Random`` five times,
    applied to a uint8 image and a mask (a float32 image for the colour
    ones too): the same transform, the same arrays."""
    img, mask = _image_and_mask()
    for seed in range(5):
        want = AUGS[name](jaug).sample(*img.shape[:2], random.Random(seed))
        got = AUGS[name](paug).sample(*img.shape[:2], random.Random(seed))
        assert type(got).__name__ == type(want).__name__
        assert got.out_size(*img.shape[:2]) == want.out_size(*img.shape[:2])
        for x in (img, img.astype(np.float32) * 0.7):
            np.testing.assert_array_equal(got.apply_image(x), want.apply_image(x))
        np.testing.assert_array_equal(got.apply_mask(mask), want.apply_mask(mask))


@pytest.mark.parametrize("extra", [[], JITTER, ["input.random_flip=none", "input.lsj_aug=true"]],
                         ids=["shortest_edge", "lsj_and_colour", "lsj_no_flip"])
def test_build_pseudo_augmentation_equals_jax(extra):
    want = jaug.build_pseudo_augmentation(jax_load_config(CLIP, SMALL + extra).input)
    got = paug.build_pseudo_augmentation(load_config(CLIP, SMALL + extra).input)
    assert [type(a).__name__ for a in got] == [type(a).__name__ for a in want]
    img, _ = _image_and_mask(3, 64, 96)
    for seed in range(4):
        ws = jaug.sample_clip_transforms(want, 64, 96, random.Random(seed))
        gs = paug.sample_clip_transforms(got, 64, 96, random.Random(seed))
        np.testing.assert_array_equal(paug.apply_clip_transforms(gs, [img])[0][0],
                                      jaug.apply_clip_transforms(ws, [img])[0][0])


def test_coco_loader_and_pseudo_splits_equal_jax(coco_root):
    """The instance loader (categories by index in id order) and the
    ``coco2ytvis2019_train`` split (official ids through
    ``COCO_TO_YTVIS_2019``, images left empty dropped) give the JAX
    records; the maps equal the JAX package's."""
    from dvis_plus_tpu.data.datasets import categories as jcat

    for name in ("COCO_TO_YTVIS_2019", "COCO_TO_YTVIS_2021", "COCO_TO_OVIS"):
        assert getattr(pcat, name) == getattr(jcat, name)
    jf = os.path.join(coco_root, "coco", "annotations", "instances_train2017.json")
    im = os.path.join(coco_root, "coco", "train2017")
    filt = {k: v - 1 for k, v in pcat.COCO_TO_YTVIS_2019.items()}
    assert load_coco_instances(jf, im) == jax_load_coco_instances(jf, im)
    assert load_coco_instances(jf, im, filt) == jax_load_coco_instances(jf, im, filt)
    for name in ("coco2ytvis2019_train", "coco2ovis_train", "coco_2017_train"):
        assert get_dataset(name) == jax_get_dataset(name)
    recs = get_dataset("coco2ytvis2019_train")
    # the set's ids 1 and 2 are COCO's person and bicycle: YTVIS-19's person and motorbike
    assert {a["category_id"] for r in recs for a in r["annotations"][0]} == {0, 20}


@pytest.mark.parametrize("yaml,extra,is_train", [
    (MASKFORMER, [], True), (CLIP, [], True), (CLIP, JITTER, True), (CLIP, [], False),
    (CLIP, ["input.sampling_frame_num=3"], False)],
    ids=["image_train", "clip_train", "clip_train_lsj_colour", "clip_eval", "clip3_eval"])
def test_pseudo_video_mapper_equals_jax(coco_root, yaml, extra, is_train):
    """Every record of the synthetic set, six seeds each: every array of
    the JAX mapper's output, equal."""
    want_m = jax_mapper_for_type(jax_load_config(yaml, SMALL + extra), "image_instance", is_train)
    got_m = mapper_for_type(load_config(yaml, SMALL + extra), "image_instance", is_train)
    assert isinstance(got_m, CocoPseudoVideoMapper)
    rotated = 0
    for rec in get_dataset("coco2ytvis2019_train"):
        for seed in range(6):
            want, got = want_m(rec, seed=seed), got_m(rec, seed=seed)
            assert sorted(got) == sorted(want)
            for k in want:
                if isinstance(want[k], np.ndarray):
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
                else:
                    assert got[k] == want[k], k
            rotated += int(not np.array_equal(got["images"][0], got["images"][-1]))
    assert rotated or got["images"].shape[0] == 1  # a clip's frames differ by their rotations
    if is_train:
        assert got["masks"].shape[:2] == (3, got["images"].shape[0]) and got["valid"].any()


@pytest.mark.parametrize("yaml", [MASKFORMER, CLIP])
def test_training_loader_with_need_map_equals_jax(coco_root, yaml):
    """The ``image_instance`` training loader with
    ``datasets.dataset_need_map=[true]``: the JAX loader's batches (one JAX
    worker, so its clips come in order), and the port's with the map off."""
    opts = SMALL + ["datasets.dataset_need_map=[true]"]
    jcfg = jax_load_config(yaml, opts)
    jmapper = jax_mapper_for_type(jcfg, "image_instance", True, dataset_name="coco2ytvis2019_train",
                                  need_map=True)
    want = jax_build_train_loader(jcfg, "coco2ytvis2019_train", mapper=jmapper, seed=4, num_workers=1)
    got = build_combined_train_loader(load_config(yaml, opts), seed=4, num_workers=2)
    plain = build_combined_train_loader(load_config(yaml, SMALL), seed=4, num_workers=0)
    for _ in range(3):
        w, g, p = next(want), next(got), next(plain)
        for k in ("images", "labels", "masks", "valid", "frame_valid"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            np.testing.assert_array_equal(p[k], w[k], err_msg=k)
