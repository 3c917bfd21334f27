"""VIS prediction rows and ``results.json``.

Counterpart: ``dvis_plus_tpu/evaluation/evaluators.py::YTVISEvaluator``
(``process`` builds the same rows; the reference is
``ytvis_eval.py::instances_to_coco_json_video``). AP scoring is not ported:
``write_results`` writes the YouTube-VIS ``results.json`` that the JAX
package's scorer (or the official server) reads.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from dvis_plus_tpu_torch.utils import rle as rle_codec


class YTVISEvaluator:
    def __init__(self, dataset_name: str, output_dir: str,
                 contiguous_to_dataset_id: Optional[Dict[int, int]] = None):
        self.dataset_name = dataset_name
        self.output_dir = output_dir
        self.reverse_id_map = contiguous_to_dataset_id or {}
        self.predictions: List[dict] = []

    def process(self, video_id: int, output: dict) -> None:
        """output: {"pred_scores": [..], "pred_labels": [..], "pred_masks":
        a container with ``encode_frame`` / ``frame_any`` (``PackedMasks``,
        ``ColRunMasks``) or N x (T, H, W) bool}; one row per instance, one
        COCO RLE (or None when empty) per frame."""
        masks_in = output["pred_masks"]
        packed = hasattr(masks_in, "encode_frame")
        for i, (score, label) in enumerate(zip(output["pred_scores"], output["pred_labels"])):
            T = masks_in.shape[1] if packed else masks_in[i].shape[0]
            segs = []
            for t in range(T):
                if packed:
                    e = masks_in.encode_frame(i, t) if masks_in.frame_any(i, t) else None
                else:
                    m = np.asarray(masks_in[i][t], bool)
                    e = rle_codec.encode(m) if m.any() else None
                segs.append(None if e is None else
                            {"size": e["size"], "counts": e["counts"].decode("ascii")})
            self.predictions.append({
                "video_id": int(video_id),
                "score": float(score),
                "category_id": int(self.reverse_id_map.get(int(label), int(label) + 1)),
                "segmentations": segs,
            })

    def write_results(self) -> str:
        """Write ``<output_dir>/results.json``; returns its path."""
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, "results.json")
        with open(path, "w") as f:
            json.dump(self.predictions, f)
        return path
