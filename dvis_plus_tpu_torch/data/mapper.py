"""Dataset mappers: a video record -> normalized, padded frames, and in
training a sampled clip with its padded targets.

Counterpart: ``dvis_plus_tpu/data/mapper.py`` (``decode_segmentation`` :41,
``select_frames`` :56, ``YTVISDatasetMapper`` :88-226) with the resize the
eval mapper needs from ``dvis_plus_tpu/data/augmentation.py``
(``ResizeShortestEdge`` :104, ``ResizeTransform`` :34) and the training
augmentations of the port's ``data/augmentation.py``. At eval every frame of
the video is read, resized so that its shorter edge is
``input.min_size_test`` (the longer at most ``input.max_size_test``),
normalized, and zero-padded at the bottom and the right up to a multiple of
``model.size_divisibility``.

:func:`mapper_for_type` is ``dvis_plus_tpu/data/build.py::mapper_for_type``
(:26-73) for every set type but ``image_panoptic``.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

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


def decode_segmentation(seg, h: int, w: int) -> np.ndarray:
    """An RLE dict, a polygon list, a decoded ``{"_raw": mask}`` (the
    pseudo-video mapper's) or None -> (h, w) uint8 mask
    (``dvis_plus_tpu/data/mapper.py::decode_segmentation`` :41)."""
    if seg is None:
        return np.zeros((h, w), np.uint8)
    if isinstance(seg, dict):
        if "_raw" in seg:
            return seg["_raw"]
        from dvis_plus_tpu_torch.utils import rle

        return rle.decode(seg)
    import cv2

    mask = np.zeros((h, w), np.uint8)
    polys = [np.asarray(p, np.float64).reshape(-1, 2).astype(np.int32) for p in seg]
    cv2.fillPoly(mask, polys, 1)
    return mask


def select_frames(video_length: int, num: int, frame_range: int, shuffle: bool,
                  rng: random.Random) -> List[int]:
    """A training clip's frame indices (``select_frames`` :56, the
    reference's :234-289): a contiguous window, reversed half the time, when
    ``2 * frame_range + 1 == num``; else a reference frame and ``num - 1``
    others within ``frame_range`` of it, sorted (shuffled with ``shuffle``)."""
    if frame_range * 2 + 1 == num:
        if num > video_length:
            idx = list(range(video_length)) + [video_length - 1] * (num - video_length)
        else:
            start = rng.randint(0, video_length - num)
            idx = list(range(start, start + num))
        if rng.random() < 0.5:
            idx = idx[::-1]
        return idx
    ref = rng.randrange(video_length)
    lo, hi = max(0, ref - frame_range), min(video_length, ref + frame_range + 1)
    pool = [i for i in range(lo, hi) if i != ref]
    if len(pool) >= num - 1:
        picks = rng.sample(pool, num - 1)
    else:
        picks = [rng.choice(pool) if pool else ref for _ in range(num - 1)]
    idx = sorted(picks + [ref])
    if shuffle:
        rng.shuffle(idx)
    return idx


def _read_frames(record: dict, frame_idx) -> List[np.ndarray]:
    import cv2

    preloaded = record.get("_frames")  # in-memory RGB frames
    frames = []
    for fi in frame_idx:
        if preloaded is not None:
            frames.append(preloaded[fi])
            continue
        img = cv2.imread(record["file_names"][fi], cv2.IMREAD_COLOR)
        if img is None:
            img = np.zeros((record["height"], record["width"], 3), np.uint8)
        frames.append(img[:, :, ::-1])  # BGR -> RGB
    return frames


class YTVISDatasetMapper:
    """record -> {"images": (T, H, W, 3) float32 normalized and padded,
    "image_size": valid (h, w) on the canvas, "height" / "width": original,
    "video_id", "file_names", "frame_indices"}; in training also the padded
    targets "labels" (N,), "masks" (N, T, H, W) bool, "valid" (N,) and
    "frame_valid" (N, T).

    Eval: every frame, resized to ``input.min_size_test`` (longer edge at
    most ``max_size_test``), padded to a multiple of
    ``model.size_divisibility``. Training (``is_train``): a clip of
    ``input.sampling_frame_num`` frames (:func:`select_frames`), the
    instances of its frames in order of first appearance up to
    ``model.criterion.max_num_instances``, the clip augmentations, and one
    static canvas (the largest training size rounded up to the
    divisibility, 480x768 by default): a clip larger than it is scaled to
    fit. Every draw comes from ``random.Random(seed)``."""

    def __init__(self, cfg, is_train: bool = False):
        self.is_train = is_train
        self.min_size = cfg.input.min_size_test
        self.max_size = cfg.input.max_size_test
        self.pixel_mean = np.asarray(cfg.model.pixel_mean, np.float32)
        self.pixel_std = np.asarray(cfg.model.pixel_std, np.float32)
        self.div = cfg.model.size_divisibility
        if is_train:
            from dvis_plus_tpu_torch.data.augmentation import build_train_augmentation

            i = cfg.input
            self.num_frames, self.frame_range = i.sampling_frame_num, i.sampling_frame_range
            self.shuffle = i.sampling_frame_shuffle
            self.augs = build_train_augmentation(i)
            self.max_instances = cfg.model.criterion.max_num_instances
            self.canvas = (_round_up(max(i.min_size_train), self.div),
                           _round_up(i.max_size_train, self.div))

    def __call__(self, record: dict, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """``seed``: the training clip's draws; the eval mapper draws nothing."""
        if self.is_train:
            return self._train(record, seed)
        import cv2

        frames = _read_frames(record, range(record["length"]))
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

    def _train(self, record: dict, seed: Optional[int]) -> Dict[str, np.ndarray]:
        import cv2

        from dvis_plus_tpu_torch.data.augmentation import apply_clip_transforms, sample_clip_transforms

        rng = random.Random(seed)
        frame_idx = select_frames(record["length"], self.num_frames, self.frame_range,
                                  self.shuffle, rng)
        frames = _read_frames(record, frame_idx)
        H0, W0 = frames[0].shape[:2]

        masks_per_frame = None
        inst_ids: List[int] = []
        inst_labels: Dict[int, int] = {}
        if record.get("annotations") is not None:
            for fi in frame_idx:
                for ann in record["annotations"][fi]:
                    inst_labels.setdefault(ann["id"], ann["category_id"])
            inst_ids = list(inst_labels)[: self.max_instances]
            masks_per_frame = []
            for fi in frame_idx:
                by_id = {a["id"]: a for a in record["annotations"][fi]}
                masks_per_frame.append([
                    decode_segmentation(by_id[i]["segmentation"] if i in by_id else None, H0, W0)
                    for i in inst_ids])

        transforms = sample_clip_transforms(self.augs, H0, W0, rng)
        frames, masks_per_frame = apply_clip_transforms(transforms, frames, masks_per_frame)
        h, w = frames[0].shape[:2]
        ch, cw = self.canvas
        scale = min(1.0, ch / h, cw / w)
        if scale < 1.0:  # fit the static canvas
            nh, nw = int(h * scale), int(w * scale)
            frames = [cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR) for f in frames]
            if masks_per_frame is not None:
                masks_per_frame = [[cv2.resize(m, (nw, nh), interpolation=cv2.INTER_NEAREST)
                                    for m in ms] for ms in masks_per_frame]
            h, w = nh, nw

        T, N = len(frames), self.max_instances
        images = np.zeros((T, ch, cw, 3), np.float32)
        for t, f in enumerate(frames):
            images[t, :h, :w] = (f.astype(np.float32) - self.pixel_mean) / self.pixel_std
        labels = np.zeros((N,), np.int32)
        masks = np.zeros((N, T, ch, cw), bool)
        frame_valid = np.zeros((N, T), bool)
        for n, iid in enumerate(inst_ids):
            labels[n] = inst_labels[iid]
            for t in range(T):
                m = masks_per_frame[t][n]
                if m.any():
                    masks[n, t, :h, :w] = m.astype(bool)
                    frame_valid[n, t] = True
        return {
            "images": images,
            "image_size": np.asarray([h, w], np.int32),
            "height": record.get("height", H0),
            "width": record.get("width", W0),
            "video_id": record.get("video_id", 0),
            "file_names": record["file_names"],
            "frame_indices": np.asarray(frame_idx, np.int32),
            "labels": labels,
            "masks": masks,
            "valid": frame_valid.any(axis=1),
            "frame_valid": frame_valid,
        }


class SOTDatasetMapper:
    """Class-agnostic video object segmentation sets (YouTube-VOS, MOSE):
    ``dvis_plus_tpu/data/mapper_sot.py::SOTDatasetMapper`` (:19), which
    relabels every annotation to category 0 and maps the record through the
    video mapper; in training the labels are zeroed after the mapping too.
    The eval mapper reads no annotation, so its output is the video
    mapper's; like the JAX mapper it gives no first-frame masks
    (``engine.daq_inference._vos_output``)."""

    def __init__(self, cfg, is_train: bool = False):
        self._base = YTVISDatasetMapper(cfg, is_train=is_train)
        self.is_train = is_train

    def __call__(self, record: dict, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        rec = dict(record)
        if rec.get("annotations") is not None:
            rec["annotations"] = [[dict(a, category_id=0) for a in frame] for frame in rec["annotations"]]
        out = self._base(rec, seed)
        if self.is_train:
            out["labels"][:] = 0
        return out


EVAL_DATASET_TYPES = ("video_instance", "video_panoptic", "video_semantic", "video_sot",
                      "image_instance", "image_panoptic")


def _categories(dataset_name: str):
    """The registered categories of ``dataset_name`` (None without a name)."""
    from dvis_plus_tpu_torch.data.catalog import get_metadata

    return getattr(get_metadata(dataset_name), "categories", None) if dataset_name else None


def mapper_for_type(cfg, dataset_type: str, is_train: bool = False, dataset_name: str = ""):
    """The mapper of a ``datasets.dataset_type_test`` entry, or in training
    of a ``datasets.dataset_type`` entry for the set ``dataset_name``
    (``dvis_plus_tpu/data/build.py::mapper_for_type`` :26-73): the video
    instance sets through :class:`YTVISDatasetMapper`, the COCO instance
    sets (``image_instance``) through the pseudo-video mapper and the COCO
    panoptic ones (``image_panoptic``) through its panoptic form with the
    set's registered categories (at eval too, as the JAX test loader), the
    class-agnostic object sets through :class:`SOTDatasetMapper`; in
    training the panoptic sets through ``PanopticVideoMapper`` with the
    set's registered categories and the semantic sets through
    ``SemanticVideoMapper`` with ``model.num_classes``
    (``data/datasets/vps_vss.py``), at eval through the video mapper (the
    JAX mappers also decode the ground-truth masks there, which no inference
    reads).

    ``datasets.dataset_need_map`` changes no mapper, as in the JAX package:
    there the video instance mapper is handed the set's
    ``thing_dataset_id_to_contiguous_id`` and reads it nowhere
    (``mapper.py:93``), and every set the port registers already gives
    contiguous training ids (the COCO pseudo-video splits map theirs at
    load)."""
    if dataset_type == "image_instance":
        from dvis_plus_tpu_torch.data.pseudo_video import CocoPseudoVideoMapper

        return CocoPseudoVideoMapper(cfg, is_train=is_train)
    if dataset_type == "video_sot":
        return SOTDatasetMapper(cfg, is_train=is_train)
    if dataset_type == "image_panoptic":
        from dvis_plus_tpu_torch.data.pseudo_video import CocoPanopticPseudoVideoMapper

        return CocoPanopticPseudoVideoMapper(cfg, is_train=is_train, categories=_categories(dataset_name))
    if is_train and dataset_type == "video_panoptic":
        from dvis_plus_tpu_torch.data.datasets.vps_vss import PanopticVideoMapper

        return PanopticVideoMapper(cfg, categories=_categories(dataset_name))
    if is_train and dataset_type == "video_semantic":
        from dvis_plus_tpu_torch.data.datasets.vps_vss import SemanticVideoMapper

        return SemanticVideoMapper(cfg, num_classes=cfg.model.num_classes)
    if dataset_type in EVAL_DATASET_TYPES:
        return YTVISDatasetMapper(cfg, is_train=is_train)
    raise NotImplementedError(f"dataset_type {dataset_type}")
