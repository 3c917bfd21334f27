"""Generate tiny synthetic datasets in the on-disk layouts the CLIs expect,
with the port's own categories and RLE codec.

Counterpart: ``tools/synth_data.py`` of the JAX package (``make_ytvis`` :40,
``make_vipseg`` :88, ``make_vspw`` :130, ``make_coco`` :153, ``main`` :211),
whose tree this writes byte for byte for the same arguments. The layouts
mirror the reference's dataset registration
(``DVIS_Plus/dvis_Plus/data_video/datasets/builtin.py:22-122``, vps.py,
vss.py).

Usage:  python -m dvis_plus_tpu_torch.tools.synth_data --root /tmp/dvis_synth \
            [--datasets ytvis_2019 ytvis_2021 ovis lvvis bdd vipseg vspw coco]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _write_jpg(path: str, h: int, w: int, rng) -> None:
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, rng.randint(0, 255, (h, w, 3), np.uint8))


def _rle(mask: np.ndarray) -> dict:
    from dvis_plus_tpu_torch.utils import rle as rle_codec

    e = rle_codec.encode(mask.astype(np.uint8))
    return {"size": e["size"], "counts": e["counts"].decode("ascii")}


def _moving_box_mask(H, W, k, f):
    m = np.zeros((H, W), np.uint8)
    m[10 + 8 * k : 28 + 8 * k, 8 + 2 * f : 32 + 2 * f] = 1
    return m


def make_ytvis(root: str, name: str, classes, splits=("train", "valid"),
               n_videos=2, length=6, H=64, W=96, layout="ytvis") -> None:
    """COCO-video json + JPEGImages tree (ytvis_2019/2021/2022/ovis/lvvis)."""
    rng = np.random.RandomState(0)
    for split in splits:
        if layout == "ovis":
            img_root = os.path.join(root, name, split)
            json_file = os.path.join(root, name, f"annotations_{split}.json")
        elif layout == "lvvis":
            img_root = os.path.join(root, name, split, "JPEGImages")
            json_file = os.path.join(root, name, f"{split}_instances.json")
        elif layout == "bdd":
            img_root = os.path.join(root, "bdd100k/images/seg_track_20", split)
            json_file = os.path.join(
                root, "bdd100k/labels/seg_track_20",
                f"seg_track_{split}_cocoformat_uni.json")
        else:
            img_root = os.path.join(root, name, split, "JPEGImages")
            json_file = os.path.join(root, name, f"{split}.json" if split != "train" else "train.json")
        videos, annotations = [], []
        ann_id = 1
        for vid in range(1, n_videos + 1):
            file_names = []
            for f in range(length):
                fn = f"v{vid}/{f:03d}.jpg"
                _write_jpg(os.path.join(img_root, fn), H, W, rng)
                file_names.append(fn)
            videos.append({"id": vid, "file_names": file_names,
                           "height": H, "width": W, "length": length})
            for k in range(2):
                segs = []
                for f in range(length):
                    if k == 1 and f >= length // 2:
                        segs.append(None)
                    else:
                        segs.append(_rle(_moving_box_mask(H, W, k, f)))
                annotations.append({
                    "id": ann_id, "video_id": vid, "category_id": k + 1,
                    "segmentations": segs, "iscrowd": 0,
                })
                ann_id += 1
        cats = [{"id": i + 1, "name": c} for i, c in enumerate(classes)]
        os.makedirs(os.path.dirname(json_file), exist_ok=True)
        with open(json_file, "w") as fp:
            json.dump({"videos": videos, "annotations": annotations,
                       "categories": cats}, fp)


def make_vipseg(root: str, n_videos=2, length=4, H=64, W=96) -> None:
    """VIPSeg 720p layout expected by ``register_all_vipseg``: images/ +
    panopticapi RGB-encoded panomasksRGB/ + per-video panoptic_gt json
    (reference datasets/vps.py:302-340)."""
    import cv2

    rng = np.random.RandomState(1)
    base = os.path.join(root, "VIPSeg", "VIPSeg_720P")
    annotations = []
    for vid in range(1, n_videos + 1):
        vname = f"video_{vid:04d}"
        frames = []
        for f in range(length):
            img = os.path.join(base, "images", vname, f"{f:05d}.jpg")
            _write_jpg(img, H, W, rng)
            ids = np.full((H, W), 1, np.int32)  # stuff segment id 1 (cat 2)
            ids[10:30, 8 + 2 * f : 40 + 2 * f] = 21  # thing segment (cat 0)
            rgb = np.stack(
                [ids % 256, (ids // 256) % 256, (ids // 65536) % 256], -1
            ).astype(np.uint8)
            png = os.path.join(base, "panomasksRGB", vname, f"{f:05d}.png")
            os.makedirs(os.path.dirname(png), exist_ok=True)
            cv2.imwrite(png, rgb[:, :, ::-1])
            frames.append({
                "file_name": f"{f:05d}.png", "height": H, "width": W,
                "segments_info": [
                    {"id": 21, "category_id": 0, "isthing": 1,
                     "area": 600, "iscrowd": 0},
                    {"id": 1, "category_id": 2, "isthing": 0,
                     "area": H * W - 600, "iscrowd": 0},
                ],
            })
        annotations.append({"video_id": vname, "annotations": frames})
    cats = [{"id": 0, "name": "person", "isthing": 1},
            {"id": 1, "name": "car", "isthing": 1},
            {"id": 2, "name": "sky", "isthing": 0}]
    os.makedirs(base, exist_ok=True)
    for split in ("train", "val"):
        with open(os.path.join(base, f"panoptic_gt_VIPSeg_{split}.json"), "w") as fp:
            json.dump({"annotations": annotations, "categories": cats}, fp)


def make_vspw(root: str, n_videos=2, length=4, H=64, W=96) -> None:
    """VSPW layout: data/<video>/origin/*.jpg + mask/*.png and train.txt/val.txt
    (reference datasets/vss.py:225-257)."""
    import cv2

    rng = np.random.RandomState(2)
    base = os.path.join(root, "VSPW_480p")
    names = []
    for vid in range(1, n_videos + 1):
        vname = f"video_{vid:04d}"
        names.append(vname)
        for f in range(length):
            _write_jpg(os.path.join(base, "data", vname, "origin", f"{f:05d}.jpg"), H, W, rng)
            m = np.full((H, W), 1, np.uint8)
            m[20:40, 10 + 3 * f : 50 + 3 * f] = 2
            png = os.path.join(base, "data", vname, "mask", f"{f:05d}.png")
            os.makedirs(os.path.dirname(png), exist_ok=True)
            cv2.imwrite(png, m)
    for split in ("train", "val", "test"):
        with open(os.path.join(base, f"{split}.txt"), "w") as fp:
            fp.write("\n".join(names) + "\n")


def make_coco(root: str, n_images=4, H=64, W=96) -> None:
    """COCO instances + panoptic layout for pseudo-video & image pretraining."""
    import cv2

    rng = np.random.RandomState(3)
    img_dir = os.path.join(root, "coco", "train2017")
    images, annotations = [], []
    pan_annotations = []
    pan_dir = os.path.join(root, "coco", "panoptic_train2017")
    os.makedirs(pan_dir, exist_ok=True)
    ann_id = 1
    for i in range(1, n_images + 1):
        fn = f"{i:012d}.jpg"
        _write_jpg(os.path.join(img_dir, fn), H, W, rng)
        images.append({"id": i, "file_name": fn, "height": H, "width": W})
        segments_info = []
        pan_png = np.zeros((H, W, 3), np.uint8)
        for k in range(2):
            m = _moving_box_mask(H, W, k, i % 3)
            ys, xs = np.nonzero(m)
            bbox = [int(xs.min()), int(ys.min()),
                    int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)]
            annotations.append({
                "id": ann_id, "image_id": i, "category_id": k + 1,
                "segmentation": _rle(m), "bbox": bbox,
                "area": int(m.sum()), "iscrowd": 0,
            })
            seg_id = ann_id
            pan_png[m > 0] = [seg_id % 256, seg_id // 256, 0]
            segments_info.append({"id": seg_id, "category_id": k + 1,
                                  "iscrowd": 0, "area": int(m.sum()),
                                  "bbox": bbox})
            ann_id += 1
        # stuff background segment (panoptic-only, like real COCO panoptic):
        # everything the thing boxes don't cover
        bg = (pan_png.sum(axis=-1) == 0)
        seg_id = ann_id
        pan_png[bg] = [seg_id % 256, seg_id // 256, 0]
        segments_info.append({"id": seg_id, "category_id": 3,
                              "iscrowd": 0, "area": int(bg.sum()),
                              "bbox": [0, 0, W, H]})
        ann_id += 1
        pan_fn = fn.replace(".jpg", ".png")
        cv2.imwrite(os.path.join(pan_dir, pan_fn), pan_png[:, :, ::-1])
        pan_annotations.append({"image_id": i, "file_name": pan_fn,
                                "segments_info": segments_info})
    pan_cats = [{"id": 1, "name": "person", "isthing": 1},
                {"id": 2, "name": "car", "isthing": 1},
                {"id": 3, "name": "sky", "isthing": 0}]
    cats = [{"id": 1, "name": "person", "isthing": 1},
            {"id": 2, "name": "car", "isthing": 1}]
    os.makedirs(os.path.join(root, "coco", "annotations"), exist_ok=True)
    with open(os.path.join(root, "coco", "annotations", "instances_train2017.json"), "w") as fp:
        json.dump({"images": images, "annotations": annotations, "categories": cats}, fp)
    with open(os.path.join(root, "coco", "annotations", "panoptic_train2017.json"), "w") as fp:
        json.dump({"images": images, "annotations": pan_annotations, "categories": pan_cats}, fp)


def main(argv=None):
    from dvis_plus_tpu_torch.data.datasets.categories import (
        BDD_TRACK_CLASSES,
        OVIS_CLASSES,
        YTVIS_2019_CLASSES,
        YTVIS_2021_CLASSES,
    )

    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--datasets", nargs="*",
                   default=["ytvis_2019", "ytvis_2021", "ovis", "vipseg", "vspw", "coco"])
    args = p.parse_args(argv)
    for d in args.datasets:
        if d == "ytvis_2019":
            make_ytvis(args.root, "ytvis_2019", YTVIS_2019_CLASSES)
        elif d == "ytvis_2021":
            make_ytvis(args.root, "ytvis_2021", YTVIS_2021_CLASSES)
        elif d == "ovis":
            make_ytvis(args.root, "ovis", OVIS_CLASSES, layout="ovis")
        elif d == "lvvis":
            make_ytvis(args.root, "lvvis", ["a", "b"], splits=("train", "val"), layout="lvvis")
        elif d == "bdd":
            make_ytvis(args.root, "bdd", BDD_TRACK_CLASSES,
                       splits=("train", "val"), layout="bdd")
        elif d == "vipseg":
            make_vipseg(args.root)
        elif d == "vspw":
            make_vspw(args.root)
        elif d == "coco":
            make_coco(args.root)
        else:
            raise SystemExit(f"unknown dataset {d}")
        print(f"wrote {d} under {args.root}")


if __name__ == "__main__":
    main()
