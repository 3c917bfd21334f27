"""Task evaluators: VIS prediction rows and ``results.json``; VPS panoptic
PNGs and ``pred.json``; VSS semantic PNGs.

Counterpart: ``dvis_plus_tpu/evaluation/evaluators.py`` (``YTVISEvaluator``,
whose ``process`` builds the same rows, the reference being
``ytvis_eval.py::instances_to_coco_json_video``; ``VPSEvaluator`` :109;
``VSSEvaluator`` :193; ``UniYTVISEvaluator`` :237, MOTS). The CLI scores
VIS and MOTS rows with ``evaluation.ytvos_eval``; the VPS and VSS evaluators
score in-process (``evaluation.offline_scoring``) when the ground truth is
on disk. All are single-process: the cross-host gather comes with multi-device eval
(ROADMAP A15). PNGs are written by ``utils.png`` (no OpenCV).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from dvis_plus_tpu_torch.utils import rle as rle_codec
from dvis_plus_tpu_torch.utils.png import write_png


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


class UniYTVISEvaluator(YTVISEvaluator):
    """MOTS evaluator (``dvis_plus_tpu/evaluation/evaluators.py::
    UniYTVISEvaluator`` :237): the YTVIS rows, and BDD-format dict outputs
    (``process_bdd``) passed through per key, each key written as
    ``<output_dir>/<key>.json`` beside ``results.json``. Single-process: the
    cross-host gather of the keys comes with ROADMAP A15."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._bdd: Dict[str, List] = {}

    def process_bdd(self, outputs: Dict[str, List]) -> None:
        for k, v in outputs.items():
            self._bdd.setdefault(k, []).extend(v)

    def write_results(self) -> str:
        path = super().write_results()
        for k, v in sorted(self._bdd.items()):
            with open(os.path.join(self.output_dir, f"{k}.json"), "w") as f:
                json.dump(v, f)
        return path


def _png_name(frame_name: str) -> str:
    return os.path.splitext(os.path.basename(frame_name))[0] + ".png"


class VPSEvaluator:
    """Per-frame panoptic PNGs (``<output_dir>/pan_pred/<video>/<frame>.png``)
    and ``pred.json`` rows. ``contiguous_to_dataset_id`` maps the model's
    things-first contiguous classes back to dataset category ids; each
    frame's rows carry its segments' ``area`` and ``iscrowd``, so that the
    output can be scored by the reference's VPQ / STQ scripts too."""

    def __init__(self, dataset_name: str, output_dir: str,
                 contiguous_to_dataset_id: Optional[Dict[int, int]] = None,
                 gt_json: Optional[str] = None, gt_dir: Optional[str] = None):
        self.output_dir = output_dir
        self.contiguous_to_dataset_id = contiguous_to_dataset_id or {}
        self.gt_json = gt_json
        self.gt_dir = gt_dir
        os.makedirs(os.path.join(output_dir, "pan_pred"), exist_ok=True)
        self.annotations: List[dict] = []

    def process(self, video_id: str, frame_names: List[str],
                panoptic_seg: np.ndarray,  # (T, H, W) int32 segment ids, 0 = void
                segments_infos: List[dict]) -> None:
        vdir = os.path.join(self.output_dir, "pan_pred", str(video_id))
        os.makedirs(vdir, exist_ok=True)
        annos = []
        for t in range(panoptic_seg.shape[0]):
            seg = np.ascontiguousarray(panoptic_seg[t], dtype="<i4")
            # RGB = the id map's low three bytes (id = R + 256 G + 65536 B), read
            # in place from the little-endian int32s; void (0) stays black
            img = seg.view(np.uint8).reshape(*seg.shape, 4)[..., :3]
            name = _png_name(frame_names[t])
            write_png(os.path.join(vdir, name), img)
            counts = np.bincount(seg.ravel())
            segs = []
            for info in segments_infos:
                sid = int(info["id"])
                area = int(counts[sid]) if sid < len(counts) else 0
                if area == 0:
                    continue
                cat = int(info["category_id"])
                segs.append({"id": info["id"],
                             "category_id": self.contiguous_to_dataset_id.get(cat, cat),
                             "isthing": info["isthing"], "area": area, "iscrowd": 0})
            annos.append({"file_name": name, "segments_info": segs})
        self.annotations.append({"video_id": str(video_id), "annotations": annos})

    def evaluate(self) -> Dict[str, float]:
        """Write ``pred.json``; with the ground truth on disk, VPQ and STQ."""
        with open(os.path.join(self.output_dir, "pred.json"), "w") as f:
            json.dump({"annotations": self.annotations}, f)
        res: Dict[str, float] = {"videos": len(self.annotations)}
        if (self.gt_json and os.path.exists(self.gt_json)
                and self.gt_dir and os.path.isdir(self.gt_dir)):
            from dvis_plus_tpu_torch.evaluation.offline_scoring import score_vps

            res.update(score_vps(self.output_dir, self.gt_json, self.gt_dir))
        return res


class VSSEvaluator:
    """Per-frame semantic class PNGs (``<output_dir>/<video>/<frame>.png``,
    class ids as uint8). With ``gt_root`` (a VSPW tree) ``evaluate`` also
    scores mIoU and VC."""

    def __init__(self, dataset_name: str, output_dir: str, gt_root: Optional[str] = None,
                 split: str = "val", num_classes: int = 124):
        self.output_dir = output_dir
        self.gt_root = gt_root
        self.split = split
        self.num_classes = num_classes
        os.makedirs(output_dir, exist_ok=True)
        self.videos = 0

    def process(self, video_id: str, frame_names: List[str], sem_seg: np.ndarray) -> None:
        vdir = os.path.join(self.output_dir, str(video_id))
        os.makedirs(vdir, exist_ok=True)
        for t in range(sem_seg.shape[0]):
            write_png(os.path.join(vdir, _png_name(frame_names[t])), sem_seg[t].astype(np.uint8))
        self.videos += 1

    def evaluate(self) -> Dict[str, float]:
        res: Dict[str, float] = {"videos": self.videos}
        if self.gt_root and os.path.exists(os.path.join(self.gt_root, f"{self.split}.txt")):
            from dvis_plus_tpu_torch.evaluation.offline_scoring import score_vss

            res.update(score_vss(self.output_dir, self.gt_root, split=self.split,
                                 num_classes=self.num_classes))
        return res
