"""COCO images as pseudo-video clips (the ``image_instance`` and
``image_panoptic`` sets).

Counterpart: ``dvis_plus_tpu/data/pseudo_video.py::CocoPseudoVideoMapper``
(:29-124), the reference's ``CocoClipDatasetMapper``: one image record
becomes a clip of ``input.sampling_frame_num`` frames, each the image (read
as RGB) under its own rotation (probability 0.5, an angle in [-15, 15]
degrees, the canvas expanded to hold it), its instances keeping their
annotation ids so that the clip's tracks are consistent. Every frame and
mask is padded at the bottom and the right to the largest frame's size, and
the clip then goes through the video mapper with the pseudo-video
augmentations (``augmentation.build_pseudo_augmentation``) in training, or
the eval mapper's resize. The draws: the rotations from
``random.Random(seed)``, then the video mapper's own from a fresh
``random.Random(seed)``, as in the JAX package, so the arrays are bit-equal.

:class:`CocoPanopticPseudoVideoMapper` (``CocoPanopticPseudoVideoMapper``
:126-183 there, the reference's ``OpenVocabularyCocoPanoClipDatasetMapper``)
makes the clip of a panoptic record: every non-crowd segment of its PNG,
thing or stuff, becomes one tracked instance of its things-first contiguous
class (the order of the COCO panoptic vocabulary's rows).
"""
from __future__ import annotations

import random
from typing import Dict, Optional

import numpy as np

from dvis_plus_tpu_torch.data.augmentation import RandomRotation, build_pseudo_augmentation
from dvis_plus_tpu_torch.data.datasets.vps_vss import decode_panoptic_png, panoptic_contiguous_maps
from dvis_plus_tpu_torch.data.mapper import YTVISDatasetMapper, decode_segmentation


class CocoPseudoVideoMapper:
    """A COCO record (``data/datasets/coco.py``, its category ids already
    the training ids) -> the video mapper's arrays for a clip of
    ``input.sampling_frame_num`` rotated frames. (The JAX mapper's
    ``category_map`` argument, which no caller there passes, is left out.)"""

    def __init__(self, cfg, is_train: bool = True):
        self.base = YTVISDatasetMapper(cfg, is_train=is_train)
        if is_train:
            self.base.augs = build_pseudo_augmentation(cfg.input)
        self.num_frames = cfg.input.sampling_frame_num
        self.rotation = RandomRotation((-15, 15), prob=0.5)

    def __call__(self, record: dict, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        import cv2

        rng = random.Random(seed)
        img = cv2.imread(record["file_name"], cv2.IMREAD_COLOR)
        if img is None:
            img = np.zeros((record.get("height", 480), record.get("width", 640), 3), np.uint8)
        H0, W0 = img.shape[:2]

        raw = record.get("annotations", [])
        if raw and isinstance(raw[0], list):
            raw = raw[0]  # the one frame of a COCO record
        anns = [{"id": a.get("id", i), "category_id": a["category_id"],
                 "mask": decode_segmentation(a.get("segmentation"), H0, W0),
                 "iscrowd": a.get("iscrowd", 0)} for i, a in enumerate(raw)]

        frames, masks = [], []
        for _ in range(self.num_frames):
            rot = self.rotation.sample(H0, W0, rng)
            frames.append(rot.apply_image(img[:, :, ::-1]))  # RGB
            masks.append([rot.apply_mask(a["mask"]) for a in anns])
        # rotations expand the canvas by their angle: pad every frame to the largest
        mh, mw = max(f.shape[0] for f in frames), max(f.shape[1] for f in frames)
        frames = [np.pad(f, ((0, mh - f.shape[0]), (0, mw - f.shape[1]), (0, 0))) for f in frames]
        per_frame = [[{"id": a["id"], "category_id": a["category_id"], "iscrowd": a["iscrowd"],
                       "segmentation": {"_raw": np.pad(m, ((0, mh - m.shape[0]), (0, mw - m.shape[1])))}}
                      for a, m in zip(anns, ms)] for ms in masks]
        rec = {"file_names": [record["file_name"]] * self.num_frames,
               "height": record.get("height", H0), "width": record.get("width", W0),
               "length": self.num_frames, "video_id": record.get("image_id", 0),
               "annotations": per_frame, "_frames": frames}
        return self.base(rec, seed=seed)


class CocoPanopticPseudoVideoMapper(CocoPseudoVideoMapper):
    """A COCO panoptic record (``data/datasets/coco.py::load_coco_panoptic``)
    -> the clip of :class:`CocoPseudoVideoMapper` with one instance a
    non-crowd segment present in the PNG, its class the segment category's
    things-first contiguous id among ``categories`` (a category outside
    them is dropped; without ``categories`` the ids stay). A record without
    its size (0) takes the PNG's."""

    def __init__(self, cfg, is_train: bool = True, categories=None):
        super().__init__(cfg, is_train=is_train)
        self.dataset_to_contiguous = panoptic_contiguous_maps(categories)[0] if categories else None

    def __call__(self, record: dict, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        import cv2

        pan = cv2.imread(record["pan_seg_file_names"][0], cv2.IMREAD_COLOR)
        anns = []
        if pan is not None:
            seg_ids = decode_panoptic_png(pan[:, :, ::-1])  # BGR -> RGB
            for s in record.get("segments_infos", [[]])[0]:
                cat = s["category_id"]
                if s.get("iscrowd", 0):
                    continue
                if self.dataset_to_contiguous is not None:
                    if cat not in self.dataset_to_contiguous:
                        continue
                    cat = self.dataset_to_contiguous[cat]
                mask = (seg_ids == s["id"]).astype(np.uint8)
                if mask.any():
                    anns.append({"id": s["id"], "category_id": cat, "segmentation": {"_raw": mask},
                                 "iscrowd": 0})
        size = pan.shape[:2] if pan is not None else (0, 0)
        return super().__call__({"file_name": record["file_names"][0], "image_id": record.get("video_id", 0),
                                 "height": record.get("height", 0) or size[0],
                                 "width": record.get("width", 0) or size[1], "annotations": anns},
                                seed=seed)
