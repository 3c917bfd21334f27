"""MOSE / YTVOS-style VOS annotations -> COCO-video (ytvis) json, over the
port's RLE codec (``utils/rle.py``).

Counterpart: ``tools/convert_vos_to_cocovid.py`` of the JAX package, whose
json this writes byte for byte (the reference converters
``DVIS_DAQ/dvis_Plus/data_video/convert_*_to_cocovid_*.py``): per-video,
per-object PNG index masks become class-agnostic RLE tracks (category 1).

  python -m dvis_plus_tpu_torch.tools.convert_vos_to_cocovid --images JPEGImages \
      --masks Annotations --output mose_train.json
"""
import argparse
import json
import os

import numpy as np


def main(argv=None):
    import cv2

    from dvis_plus_tpu_torch.utils import rle as rle_codec

    parser = argparse.ArgumentParser()
    parser.add_argument("--images", required=True)
    parser.add_argument("--masks", required=True)
    parser.add_argument("--output", required=True)
    args = parser.parse_args(argv)

    videos, annotations = [], []
    next_ann = 1
    for vid_i, video in enumerate(sorted(os.listdir(args.images)), 1):
        frame_names = sorted(os.listdir(os.path.join(args.images, video)))
        first = cv2.imread(os.path.join(args.images, video, frame_names[0]))
        H, W = first.shape[:2]
        videos.append({
            "id": vid_i, "file_names": [f"{video}/{n}" for n in frame_names],
            "height": H, "width": W, "length": len(frame_names),
        })
        tracks = {}
        for t, name in enumerate(frame_names):
            mpath = os.path.join(args.masks, video, os.path.splitext(name)[0] + ".png")
            m = cv2.imread(mpath, cv2.IMREAD_GRAYSCALE)
            if m is None:
                continue
            for oid in np.unique(m):
                if oid == 0:
                    continue
                tracks.setdefault(int(oid), [None] * len(frame_names))
                e = rle_codec.encode((m == oid).astype(np.uint8))
                tracks[int(oid)][t] = {"size": e["size"], "counts": e["counts"].decode("ascii")}
        for oid, segs in tracks.items():
            annotations.append({
                "id": next_ann, "video_id": vid_i, "category_id": 1,
                "segmentations": segs, "iscrowd": 0,
            })
            next_ann += 1
        print(video, len(tracks))
    with open(args.output, "w") as f:
        json.dump({
            "videos": videos, "annotations": annotations,
            "categories": [{"id": 1, "name": "object"}],
        }, f)


if __name__ == "__main__":
    main()
