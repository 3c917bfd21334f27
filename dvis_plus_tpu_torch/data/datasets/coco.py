"""COCO instance sets as one-frame video records, and their registration.

Counterpart: ``dvis_plus_tpu/data/datasets/coco.py`` (``load_coco_instances``
:29, the instance splits and the pseudo-video splits of
``register_all_coco`` :130-173): ``coco_2017_{train,val}`` with the
categories of their json, and ``coco2ytvis2019_train``,
``coco2ytvis2021_train``, ``coco2ovis_train``, whose official COCO ids map
into the video set's contiguous ids at load (``categories.COCO_TO_*``), an
image with no annotation left being dropped. The records have the video
record's layout with one frame; ``data/pseudo_video.py`` makes clips of
them. The panoptic loader and splits (``load_coco_panoptic``, the
``image_panoptic`` sets of open-vocabulary training) are ROADMAP A14c.5.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from dvis_plus_tpu_torch.data.catalog import register_dataset
from dvis_plus_tpu_torch.data.datasets.categories import (
    COCO_TO_OVIS,
    COCO_TO_YTVIS_2019,
    COCO_TO_YTVIS_2021,
)


def load_coco_instances(json_file: str, image_root: str,
                        category_filter: Optional[Dict[int, int]] = None) -> List[dict]:
    """A COCO instances json -> one record an image. ``category_filter``
    maps official COCO ids to the training ids (annotations outside it are
    dropped, then the images left without one); without it the categories
    take their index in id order."""
    with open(json_file) as f:
        data = json.load(f)
    anns_by_img: Dict[int, List[dict]] = {}
    for ann in data.get("annotations", []):
        anns_by_img.setdefault(ann["image_id"], []).append(ann)
    if category_filter is None:
        id_map = {cid: i for i, cid in enumerate(sorted(c["id"] for c in data.get("categories", [])))}
    else:
        id_map = dict(category_filter)

    records = []
    for img in data["images"]:
        anns = [{"id": a["id"], "category_id": id_map[a["category_id"]],
                 "segmentation": a.get("segmentation"), "bbox": a.get("bbox"),
                 "iscrowd": a.get("iscrowd", 0)}
                for a in anns_by_img.get(img["id"], []) if a["category_id"] in id_map]
        if category_filter is not None and not anns:
            continue
        path = os.path.join(image_root, img["file_name"])
        records.append({"file_name": path, "file_names": [path], "height": img["height"],
                        "width": img["width"], "length": 1, "video_id": img["id"],
                        "image_id": img["id"], "annotations": [anns]})
    return records


def _categories_meta(json_file: str) -> Dict:
    """The categories of a json on disk (none for a json not there yet)."""
    if not os.path.exists(json_file):
        return {}
    with open(json_file) as f:
        cats = json.load(f).get("categories", [])
    return {"categories": cats,
            "thing_classes": [c["name"] for c in cats if c.get("isthing", 1)],
            "stuff_classes": [c["name"] for c in cats if not c.get("isthing", 1)],
            "thing_dataset_id_to_contiguous_id": {
                c["id"]: i for i, c in enumerate(sorted(cats, key=lambda c: c["id"]))}}


COCO_PSEUDO_SPLITS = {"coco2ytvis2019_train": COCO_TO_YTVIS_2019,
                      "coco2ytvis2021_train": COCO_TO_YTVIS_2021, "coco2ovis_train": COCO_TO_OVIS}


def register_all_coco(root: str = "datasets") -> None:
    """The COCO 2017 instance splits and the pseudo-video splits under
    ``<root>/coco``. A missing file fails only when the set is loaded."""
    coco = os.path.join(root, "coco")
    for split in ("train", "val"):
        jf = os.path.join(coco, "annotations", f"instances_{split}2017.json")
        register_dataset(f"coco_2017_{split}",
                         lambda j=jf, r=os.path.join(coco, f"{split}2017"): load_coco_instances(j, r),
                         json_file=jf, evaluator_type="coco", **_categories_meta(jf))
    jf = os.path.join(coco, "annotations", "instances_train2017.json")
    for name, mapping in COCO_PSEUDO_SPLITS.items():
        register_dataset(
            name, lambda m=mapping: load_coco_instances(
                jf, os.path.join(coco, "train2017"), category_filter={k: v - 1 for k, v in m.items()}),
            json_file=jf, evaluator_type="none")
