"""COCO instance and panoptic sets as one-frame video records, and their
registration.

Counterpart: ``dvis_plus_tpu/data/datasets/coco.py`` (``load_coco_instances``
:29, ``load_coco_panoptic`` :83, ``register_all_coco`` :130-203):
``coco_2017_{train,val}`` with the categories of their json, and
``coco2ytvis2019_train``, ``coco2ytvis2021_train``, ``coco2ovis_train``,
whose official COCO ids map into the video set's contiguous ids at load
(``categories.COCO_TO_*``), an image with no annotation left being dropped;
the panoptic sets ``coco_2017_{train,val}_panoptic``,
``coco_panoptic_video_ov`` (the open-vocabulary recipes' training set, the
``image_panoptic`` type), ``ade20k_panoptic_train`` and
``mapillary_vistas_panoptic_train``, each image with its panoptic PNG and
segments (and each segment's ``isthing`` from the json's categories). The
records have the video record's layout with one frame;
``data/pseudo_video.py`` makes clips of them.
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


def load_coco_panoptic(json_file: str, image_root: str, pan_root: str) -> List[dict]:
    """A COCO panoptic json -> one record an annotated image: its file, its
    panoptic PNG and its segments. A json without ``images`` takes them from
    the annotations (the image file named as the PNG, ``.jpg``; height and
    width 0, which the mapper reads from the PNG)."""
    with open(json_file) as f:
        data = json.load(f)
    isthing = {c["id"]: c.get("isthing", 0) for c in data.get("categories", [])}
    by_img = {a["image_id"]: a for a in data["annotations"]}
    images = data.get("images", []) or [
        {"id": a["image_id"], "file_name": a["file_name"].replace(".png", ".jpg"), "height": 0, "width": 0}
        for a in data["annotations"]]
    records = []
    for img in images:
        a = by_img.get(img["id"])
        if a is None:
            continue
        segments = [dict(s, isthing=isthing.get(s["category_id"], 0)) for s in a["segments_info"]]
        records.append({"file_names": [os.path.join(image_root, img["file_name"])],
                        "pan_seg_file_names": [os.path.join(pan_root, a["file_name"])],
                        "segments_infos": [segments], "height": img.get("height", 0),
                        "width": img.get("width", 0), "length": 1, "video_id": img["id"]})
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


def _register_panoptic(name: str, json_file: str, image_root: str, pan_root: str,
                       evaluator_type: str) -> None:
    register_dataset(name, lambda: load_coco_panoptic(json_file, image_root, pan_root),
                     json_file=json_file, evaluator_type=evaluator_type, **_categories_meta(json_file))


def register_all_coco(root: str = "datasets") -> None:
    """The COCO 2017 instance and panoptic splits and the pseudo-video
    splits under ``<root>/coco``, and the ADE20k and Mapillary Vistas
    panoptic training sets under ``<root>/ADEChallengeData2016`` and
    ``<root>/mapillary_vistas``. A missing file fails only when the set is
    loaded."""
    coco = os.path.join(root, "coco")
    for split in ("train", "val"):
        jf = os.path.join(coco, "annotations", f"instances_{split}2017.json")
        register_dataset(f"coco_2017_{split}",
                         lambda j=jf, r=os.path.join(coco, f"{split}2017"): load_coco_instances(j, r),
                         json_file=jf, evaluator_type="coco", **_categories_meta(jf))
        _register_panoptic(f"coco_2017_{split}_panoptic",
                           os.path.join(coco, "annotations", f"panoptic_{split}2017.json"),
                           os.path.join(coco, f"{split}2017"), os.path.join(coco, f"panoptic_{split}2017"),
                           "coco_panoptic")
    jf = os.path.join(coco, "annotations", "instances_train2017.json")
    for name, mapping in COCO_PSEUDO_SPLITS.items():
        register_dataset(
            name, lambda m=mapping: load_coco_instances(
                jf, os.path.join(coco, "train2017"), category_filter={k: v - 1 for k, v in m.items()}),
            json_file=jf, evaluator_type="none")
    # COCO panoptic as pseudo-videos, the open-vocabulary recipes' training
    # set, under the reference's name (``image_panoptic`` type)
    _register_panoptic("coco_panoptic_video_ov", os.path.join(coco, "annotations", "panoptic_train2017.json"),
                       os.path.join(coco, "train2017"), os.path.join(coco, "panoptic_train2017"), "none")
    ade = os.path.join(root, "ADEChallengeData2016")
    _register_panoptic("ade20k_panoptic_train", os.path.join(ade, "ade20k_panoptic_train.json"),
                       os.path.join(ade, "images", "training"), os.path.join(ade, "ade20k_panoptic_train"),
                       "coco_panoptic")
    mapillary = os.path.join(root, "mapillary_vistas", "training")
    _register_panoptic("mapillary_vistas_panoptic_train",
                       os.path.join(mapillary, "panoptic", "panoptic_2018.json"),
                       os.path.join(mapillary, "images"), os.path.join(mapillary, "panoptic"),
                       "coco_panoptic")
