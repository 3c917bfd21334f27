"""Evaluation dataset mapper: a video record -> normalized, padded frames.

Counterpart: the eval half of ``dvis_plus_tpu/data/mapper.py::
YTVISDatasetMapper`` (:88) with the one resize it needs from
``dvis_plus_tpu/data/augmentation.py`` (``ResizeShortestEdge`` :104,
``ResizeTransform`` :34). Every frame of the video is read, resized so that
its shorter edge is ``input.min_size_test`` (the longer at most
``input.max_size_test``), normalized, and zero-padded at the bottom and the
right up to a multiple of ``model.size_divisibility``. Clip sampling, the
training augmentations and the instance tables come with training.

:func:`mapper_for_type` is the eval half of
``dvis_plus_tpu/data/build.py::mapper_for_type`` (:26-53): the video
instance, panoptic and semantic sets all map through this mapper at eval
(the JAX panoptic and semantic mappers also decode the ground-truth masks,
which no inference reads), and the class-agnostic VOS sets through
:class:`SOTDatasetMapper`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resize_shortest_edge(h: int, w: int, size: int, max_size: int) -> Tuple[int, int]:
    """Output (h, w): the shorter edge becomes ``size`` unless the longer
    would pass ``max_size``."""
    scale = size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(round(h * scale)), int(round(w * scale))


class YTVISDatasetMapper:
    """record -> {"images": (T, H, W, 3) float32 normalized and padded,
    "image_size": valid (h, w) on the canvas, "height" / "width": original,
    "video_id", "file_names", "frame_indices"}."""

    def __init__(self, cfg):
        self.min_size = cfg.input.min_size_test
        self.max_size = cfg.input.max_size_test
        self.pixel_mean = np.asarray(cfg.model.pixel_mean, np.float32)
        self.pixel_std = np.asarray(cfg.model.pixel_std, np.float32)
        self.div = cfg.model.size_divisibility

    def __call__(self, record: dict, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """``seed`` is accepted for the training mapper's signature; the eval
        mapper draws nothing."""
        import cv2

        preloaded = record.get("_frames")  # in-memory RGB frames
        frames = []
        for fi in range(record["length"]):
            if preloaded is not None:
                frames.append(preloaded[fi])
                continue
            img = cv2.imread(record["file_names"][fi], cv2.IMREAD_COLOR)
            if img is None:
                img = np.zeros((record["height"], record["width"], 3), np.uint8)
            frames.append(img[:, :, ::-1])  # BGR -> RGB

        H0, W0 = frames[0].shape[:2]
        h, w = resize_shortest_edge(H0, W0, self.min_size, self.max_size)
        frames = [cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR) for f in frames]
        ch, cw = _round_up(h, self.div), _round_up(w, self.div)
        images = np.zeros((len(frames), ch, cw, 3), np.float32)
        for t, f in enumerate(frames):
            images[t, :h, :w] = (f.astype(np.float32) - self.pixel_mean) / self.pixel_std
        return {
            "images": images,
            "image_size": np.asarray([h, w], np.int32),
            "height": record.get("height", H0),
            "width": record.get("width", W0),
            "video_id": record.get("video_id", 0),
            "file_names": record["file_names"],
            "frame_indices": np.arange(len(frames), dtype=np.int32),
        }


class SOTDatasetMapper:
    """Class-agnostic video object segmentation sets (YouTube-VOS, MOSE),
    eval half: the eval half of ``dvis_plus_tpu/data/mapper_sot.py::
    SOTDatasetMapper`` (:19), which relabels every annotation to category 0
    and maps the record through the video mapper. The eval mapper reads no
    annotation, so its output is the video mapper's; like the JAX mapper it
    gives no first-frame masks (``engine.daq_inference._vos_output``)."""

    def __init__(self, cfg):
        self._base = YTVISDatasetMapper(cfg)

    def __call__(self, record: dict, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        rec = dict(record)
        if rec.get("annotations") is not None:
            rec["annotations"] = [[dict(a, category_id=0) for a in frame] for frame in rec["annotations"]]
        return self._base(rec, seed)


EVAL_DATASET_TYPES = ("video_instance", "video_panoptic", "video_semantic", "video_sot")


def mapper_for_type(cfg, dataset_type: str):
    """The eval mapper of a ``datasets.dataset_type_test`` entry."""
    if dataset_type == "video_sot":
        return SOTDatasetMapper(cfg)
    if dataset_type in EVAL_DATASET_TYPES:
        return YTVISDatasetMapper(cfg)
    if dataset_type.startswith("image_"):
        raise NotImplementedError(
            f"dataset type {dataset_type!r} is not ported (ROADMAP A14: the pseudo-video mappers)")
    raise NotImplementedError(f"dataset_type {dataset_type}")
