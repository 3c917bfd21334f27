"""YouTube-VIS / OVIS style dataset loading and registration: parses the
COCO-video JSON (videos, annotations with per-frame segmentations,
categories) into per-video records and registers loaders and metadata in the
port's catalog.

Counterpart: ``dvis_plus_tpu/data/datasets/ytvis.py`` (``load_ytvis_json``
:31, ``register_ytvis_instances`` :83, ``register_all_ytvis`` :98).

Record format (per video):
  {"file_names": [T paths], "height", "width", "length", "video_id",
   "annotations": [per-frame list of {"id", "category_id", "segmentation",
                                      "iscrowd", "bbox"}]}
with category_id remapped to contiguous 0-based training ids.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from dvis_plus_tpu_torch.data.catalog import register_dataset
from dvis_plus_tpu_torch.data.datasets.categories import (
    BDD_TRACK_CLASSES,
    OVIS_CLASSES,
    YTVIS_2019_CLASSES,
    YTVIS_2021_CLASSES,
    thing_dataset_id_to_contiguous_id,
)


def load_ytvis_json(
    json_file: str,
    image_root: str,
    dataset_name: Optional[str] = None,
    id_map: Optional[Dict[int, int]] = None,
) -> List[dict]:
    with open(json_file) as f:
        data = json.load(f)

    if id_map is None:
        cat_ids = sorted(c["id"] for c in data.get("categories", []))
        id_map = {cid: i for i, cid in enumerate(cat_ids)}

    anns_by_video: Dict[int, List[dict]] = {}
    for ann in data.get("annotations", []):
        anns_by_video.setdefault(ann["video_id"], []).append(ann)

    records = []
    for video in data["videos"]:
        vid = video["id"]
        length = len(video["file_names"])
        record = {
            "file_names": [
                os.path.join(image_root, fn) for fn in video["file_names"]
            ],
            "height": video["height"],
            "width": video["width"],
            "length": length,
            "video_id": vid,
        }
        frame_anns: List[List[dict]] = [[] for _ in range(length)]
        for ann in anns_by_video.get(vid, []):
            segs = ann.get("segmentations") or [None] * length
            bboxes = ann.get("bboxes") or [None] * length
            for f in range(length):
                if segs[f] is None:
                    continue
                frame_anns[f].append(
                    {
                        "id": ann["id"],
                        "category_id": id_map[ann["category_id"]],
                        "segmentation": segs[f],
                        "bbox": bboxes[f],
                        "iscrowd": ann.get("iscrowd", 0),
                    }
                )
        record["annotations"] = frame_anns
        record["has_mask"] = True
        records.append(record)
    return records


def register_ytvis_instances(
    name: str, json_file: str, image_root: str, classes: List[str]
) -> None:
    id_map = thing_dataset_id_to_contiguous_id(classes)
    register_dataset(
        name,
        lambda: load_ytvis_json(json_file, image_root, name, id_map),
        json_file=json_file,
        image_root=image_root,
        thing_classes=list(classes),
        thing_dataset_id_to_contiguous_id=id_map,
        evaluator_type="ytvis",
    )


def register_all_ytvis(root: str = "datasets") -> None:
    """The standard splits. Missing files register lazily; loading only
    fails on first access."""
    specs = {
        "ytvis_2019_train": ("ytvis_2019/train.json", "ytvis_2019/train/JPEGImages", YTVIS_2019_CLASSES),
        "ytvis_2019_val": ("ytvis_2019/valid.json", "ytvis_2019/valid/JPEGImages", YTVIS_2019_CLASSES),
        "ytvis_2019_test": ("ytvis_2019/test.json", "ytvis_2019/test/JPEGImages", YTVIS_2019_CLASSES),
        "ytvis_2021_train": ("ytvis_2021/train.json", "ytvis_2021/train/JPEGImages", YTVIS_2021_CLASSES),
        "ytvis_2021_val": ("ytvis_2021/valid.json", "ytvis_2021/valid/JPEGImages", YTVIS_2021_CLASSES),
        "ytvis_2021_test": ("ytvis_2021/test.json", "ytvis_2021/test/JPEGImages", YTVIS_2021_CLASSES),
        # the full 2022 val is "ytvis_2022_val"; the older *_val_full alias stays
        "ytvis_2022_val": ("ytvis_2022/valid/instances.json", "ytvis_2022/valid/JPEGImages", YTVIS_2021_CLASSES),
        "ytvis_2022_val_full": ("ytvis_2022/valid.json", "ytvis_2022/valid/JPEGImages", YTVIS_2021_CLASSES),
        "ovis_train": ("ovis/annotations_train.json", "ovis/train", OVIS_CLASSES),
        "ovis_val": ("ovis/annotations_valid.json", "ovis/valid", OVIS_CLASSES),
        "ovis_test": ("ovis/annotations_test.json", "ovis/test", OVIS_CLASSES),
        # BDD100K seg-track (MOTS; cocoformat-uni jsons; the *_uni_ovis
        # variant re-maps BDD to the OVIS category space)
        "bdd_seg_track_train": ("bdd100k/labels/seg_track_20/seg_track_train_cocoformat_uni.json", "bdd100k/images/seg_track_20/train", BDD_TRACK_CLASSES),
        "bdd_seg_track_val": ("bdd100k/labels/seg_track_20/seg_track_val_cocoformat_uni.json", "bdd100k/images/seg_track_20/val", BDD_TRACK_CLASSES),
        "bdd2ovis_seg_track_train": ("bdd100k/labels/seg_track_20/seg_track_train_cocoformat_uni_ovis.json", "bdd100k/images/seg_track_20/train", OVIS_CLASSES),
    }
    for name, (json_rel, img_rel, classes) in specs.items():
        register_ytvis_instances(
            name, os.path.join(root, json_rel), os.path.join(root, img_rel), classes
        )

    # LV-VIS (open-vocabulary): the categories come from the json
    for split in ("train", "val"):
        jf = os.path.join(root, f"lvvis/{split}_instances.json")
        register_dataset(
            f"lvvis_{split}",
            lambda j=jf, r=os.path.join(root, f"lvvis/{split}/JPEGImages"): load_ytvis_json(j, r),
            json_file=jf,
            thing_classes=[],
            thing_dataset_id_to_contiguous_id={},
            evaluator_type="ytvis",
        )

    # class-agnostic VOS / MOTS splits (cocovid jsons from
    # tools/convert_vos_to_cocovid.py)
    for name, sub in (
        ("mose_train", "mose/train.json"),
        ("mose_val", "mose/val.json"),
        ("ytvos_train", "ytvos/train.json"),
        ("ytvos_val", "ytvos/val.json"),
    ):
        jf = os.path.join(root, sub)
        register_dataset(
            name,
            lambda j=jf, r=os.path.join(root, os.path.dirname(sub), "JPEGImages"): load_ytvis_json(j, r),
            json_file=jf,
            thing_classes=["object"],
            thing_dataset_id_to_contiguous_id={1: 0},
            evaluator_type="vos",
        )
