"""COCO instances json -> pseudo-video YTVIS json converter, over the port's
categories (``data/datasets/categories.py``).

Counterpart: ``tools/coco2ytvis.py`` of the JAX package, whose json this
writes byte for byte: each image becomes a one-frame video, each annotation
a one-element track; ``--map`` remaps the category ids through the
``COCO_TO_*`` tables (dropping the categories outside them).

  python -m dvis_plus_tpu_torch.tools.coco2ytvis --input instances_train2017.json \
      --output coco2ytvis19.json --map ytvis19
"""
import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--map", choices=["none", "ytvis19", "ytvis21", "ovis"], default="none")
    args = parser.parse_args(argv)

    from dvis_plus_tpu_torch.data.datasets.categories import (
        COCO_TO_OVIS, COCO_TO_YTVIS_2019, COCO_TO_YTVIS_2021,
    )

    id_map = {
        "none": None, "ytvis19": COCO_TO_YTVIS_2019,
        "ytvis21": COCO_TO_YTVIS_2021, "ovis": COCO_TO_OVIS,
    }[args.map]

    with open(args.input) as f:
        coco = json.load(f)
    videos, annotations = [], []
    for img in coco["images"]:
        videos.append({
            "id": img["id"], "file_names": [img["file_name"]],
            "height": img["height"], "width": img["width"], "length": 1,
        })
    for ann in coco["annotations"]:
        cat = ann["category_id"]
        if id_map is not None:
            if cat not in id_map:
                continue
            cat = id_map[cat]
        annotations.append({
            "id": ann["id"], "video_id": ann["image_id"], "category_id": cat,
            "segmentations": [ann["segmentation"]], "areas": [ann.get("area")],
            "bboxes": [ann.get("bbox")], "iscrowd": ann.get("iscrowd", 0),
        })
    out = {"videos": videos, "annotations": annotations,
           "categories": coco.get("categories", [])}
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(f"wrote {len(videos)} pseudo-videos, {len(annotations)} tracks")


if __name__ == "__main__":
    main()
