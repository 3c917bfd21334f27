"""VIPSeg (video panoptic) and VSPW (video semantic) dataset loading,
registration and training mappers.

Counterpart: ``dvis_plus_tpu/data/datasets/vps_vss.py`` (``decode_panoptic_png``
:27, ``load_vipseg_json`` :33, ``register_all_vipseg`` :60, ``load_vspw`` :85,
``register_all_vspw`` :109, ``panoptic_contiguous_maps`` :125,
``PanopticVideoMapper`` :138-203, ``SemanticVideoMapper`` :206-249). In
training the panoptic and semantic masks become target slots, the clip
going through ``data.mapper.YTVISDatasetMapper`` as a video instance
record: on VIPSeg a thing segment is a slot of its own and the stuff of one
category one slot (id ``-1000 - category``), the classes things-first
contiguous when the set's categories are known; on VSPW each class present
is a slot. A frame's masks are read when the clip samples it (the JAX
mappers read every frame of the video, to the same batch). At eval the
frames alone go through the video mapper.

VIPSeg records: ``{"video_id" (str), "length", "file_names",
"pan_seg_file_names", "segments_infos", "height", "width"}``; panoptic PNGs
are RGB id maps (id = R + 256 G + 65536 B). VSPW records: ``{"video_id"
(str), "length", "file_names", "sem_seg_file_names"}``, no size: the eval
mapper takes the first frame's.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from dvis_plus_tpu_torch.data.catalog import register_dataset
from dvis_plus_tpu_torch.data.mapper import YTVISDatasetMapper


def decode_panoptic_png(img_rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB -> (H, W) int32 segment ids (panopticapi encoding)."""
    img = img_rgb.astype(np.int64)
    return (img[..., 0] + 256 * img[..., 1] + 65536 * img[..., 2]).astype(np.int32)


def load_vipseg_json(json_file: str, image_root: str, mask_root: str) -> List[dict]:
    with open(json_file) as f:
        data = json.load(f)
    records = []
    for ann in data["annotations"]:
        vid = ann["video_id"]
        frames = ann["annotations"]
        records.append({
            "video_id": vid,
            "length": len(frames),
            "file_names": [
                os.path.join(image_root, vid, f["file_name"].replace(".png", ".jpg"))
                for f in frames
            ],
            "pan_seg_file_names": [os.path.join(mask_root, vid, f["file_name"]) for f in frames],
            "segments_infos": [f["segments_info"] for f in frames],
            "height": frames[0].get("height", 720) if frames else 720,
            "width": frames[0].get("width", 1280) if frames else 1280,
        })
    return records


def register_all_vipseg(root: str = "datasets") -> None:
    """``panoVSPW_vps_video_{train,val,test}`` under ``<root>/VIPSeg/VIPSeg_720P``;
    when the split's json exists, its ``categories`` (and the thing and stuff
    names) join the metadata."""
    base = os.path.join(root, "VIPSeg/VIPSeg_720P")
    for split in ("train", "val", "test"):
        json_file = os.path.join(base, f"panoptic_gt_VIPSeg_{split}.json")

        def loader(jf=json_file):
            return load_vipseg_json(jf, os.path.join(base, "images"), os.path.join(base, "panomasksRGB"))

        meta: Dict = {"json_file": json_file, "evaluator_type": "vps",
                      "gt_dir": os.path.join(base, "panomasksRGB")}
        if os.path.exists(json_file):
            with open(json_file) as f:
                cats = json.load(f).get("categories", [])
            meta["thing_classes"] = [c["name"] for c in cats if c.get("isthing")]
            meta["stuff_classes"] = [c["name"] for c in cats if not c.get("isthing")]
            meta["categories"] = cats
        register_dataset(f"panoVSPW_vps_video_{split}", loader, **meta)


def load_vspw(image_root: str, split_txt: str) -> List[dict]:
    with open(split_txt) as f:
        video_names = [ln.strip() for ln in f if ln.strip()]
    records = []
    for vn in video_names:
        img_dir = os.path.join(image_root, vn, "origin")
        mask_dir = os.path.join(image_root, vn, "mask")
        if not os.path.isdir(img_dir):
            continue
        frames = sorted(os.listdir(img_dir))
        records.append({
            "video_id": vn,
            "length": len(frames),
            "file_names": [os.path.join(img_dir, f) for f in frames],
            "sem_seg_file_names": [os.path.join(mask_dir, os.path.splitext(f)[0] + ".png")
                                   for f in frames],
        })
    return records


def register_all_vspw(root: str = "datasets") -> None:
    """``VSPW_vss_video_{train,val,test}`` under ``<root>/VSPW_480p``, each
    read from its own ``<split>.txt``. (The JAX package's loader closes over
    the loop variable and so reads ``test.txt`` for every split.)"""
    base = os.path.join(root, "VSPW_480p")
    for split in ("train", "val", "test"):
        register_dataset(
            f"VSPW_vss_video_{split}",
            lambda s=split: load_vspw(os.path.join(base, "data"), os.path.join(base, f"{s}.txt")),
            evaluator_type="vss", num_classes=124, gt_root=base, split=split,
        )


def panoptic_contiguous_maps(categories):
    """Things-first contiguous training classes from a VIPSeg-style
    categories list: sorted thing ids -> [0, #things), sorted stuff ids ->
    #things + index. Returns ``(dataset_to_contiguous, contiguous_to_dataset,
    num_things)``."""
    thing_ids = sorted(c["id"] for c in categories if c.get("isthing"))
    stuff_ids = sorted(c["id"] for c in categories if not c.get("isthing"))
    d2c = {id_: i for i, id_ in enumerate(thing_ids)}
    d2c.update({id_: len(thing_ids) + i for i, id_ in enumerate(stuff_ids)})
    return d2c, {v: k for k, v in d2c.items()}, len(thing_ids)


def vspw_preprocess(m: np.ndarray) -> np.ndarray:
    """Raw VSPW masks are 1-based with 0 = void and 255 = ignore: shift to
    0-based classes with 255 void."""
    m = m.astype(np.int32)
    m = np.where(m == 0, 255, m) - 1
    return np.where(m == 254, 255, m)


class _LazyFrames:
    """A video's per-frame annotation lists, each made by ``make(i)`` when it
    is first asked for."""

    def __init__(self, n: int, make: Callable[[int], List[dict]]):
        self._n, self._make, self._done = n, make, {}

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> List[dict]:
        if i not in self._done:
            self._done[i] = self._make(i)
        return self._done[i]


class PanopticVideoMapper:
    """VIPSeg record -> training clip arrays (``YTVISDatasetMapper``'s
    training output). With ``categories`` (the set's metadata) the classes
    are things-first contiguous and a segment without ``isthing`` is a thing
    by its category; without them the dataset ids pass through and such a
    segment is stuff."""

    def __init__(self, cfg, categories: Optional[List[dict]] = None):
        self._base = YTVISDatasetMapper(cfg, is_train=True)
        self.to_contiguous = panoptic_contiguous_maps(categories)[0] if categories else None
        self.thing_ids = {c["id"] for c in categories or () if c.get("isthing")}

    def _frame(self, record: dict, i: int) -> List[dict]:
        import cv2

        img = cv2.imread(record["pan_seg_file_names"][i], cv2.IMREAD_COLOR)
        if img is None:
            return []
        ids = decode_panoptic_png(img[:, :, ::-1])
        anns = []
        for seg in record["segments_infos"][i]:
            m = (ids == seg["id"]).astype(np.uint8)
            if not m.any():
                continue
            cat = seg["category_id"]
            isthing = seg.get("isthing", cat in self.thing_ids)
            if self.to_contiguous is not None:
                cat = self.to_contiguous[cat]
            anns.append({"id": seg["id"] if isthing else -1000 - cat, "category_id": cat,
                         "segmentation": {"_raw": m}, "iscrowd": 0})
        return anns

    def __call__(self, record: dict, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        rec = dict(record)
        rec["annotations"] = _LazyFrames(len(record["pan_seg_file_names"]),
                                         lambda i: self._frame(record, i))
        return self._base(rec, seed)


class SemanticVideoMapper:
    """VSPW record -> training clip arrays: after :func:`vspw_preprocess`
    each class present in a frame (but the ignore label 255 and classes from
    ``num_classes`` on) is a slot, id ``-1000 - class``."""

    def __init__(self, cfg, num_classes: int = 124, ignore_label: int = 255):
        self._base = YTVISDatasetMapper(cfg, is_train=True)
        self.num_classes, self.ignore_label = num_classes, ignore_label

    def _frame(self, record: dict, i: int) -> List[dict]:
        import cv2

        m = cv2.imread(record["sem_seg_file_names"][i], cv2.IMREAD_GRAYSCALE)
        if m is None:
            return []
        m = vspw_preprocess(m)
        return [{"id": -1000 - int(c), "category_id": int(c),
                 "segmentation": {"_raw": (m == c).astype(np.uint8)}, "iscrowd": 0}
                for c in np.unique(m) if c != self.ignore_label and c < self.num_classes]

    def __call__(self, record: dict, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        rec = dict(record)
        rec["annotations"] = _LazyFrames(len(record["sem_seg_file_names"]),
                                         lambda i: self._frame(record, i))
        return self._base(rec, seed)
