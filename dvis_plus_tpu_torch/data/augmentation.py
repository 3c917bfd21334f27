"""Clip-consistent training augmentations (host-side numpy and cv2).

Counterpart: the training half of ``dvis_plus_tpu/data/augmentation.py``
(``ResizeShortestEdge`` :104, ``RandomFlip`` :119, ``RandomCrop`` :139,
``build_train_augmentation`` :155, ``apply_clip_transforms`` :173,
``sample_clip_transforms`` :308), the reference's clip transforms: one set of
random parameters is drawn a clip (from the mapper's ``random.Random``) and
applied to every frame and its masks. The rotation, LSJ and colour
augmentations of the pseudo-video recipe are ROADMAP A14c.2. cv2 is imported
inside the calls.
"""
from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np


class ClipTransform:
    """A transform whose parameters are drawn, applied to each frame."""

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_mask(self, mask: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def out_size(self, h: int, w: int):
        return h, w


class ResizeTransform(ClipTransform):
    def __init__(self, new_h: int, new_w: int):
        self.new_h, self.new_w = new_h, new_w

    def apply_image(self, img):
        import cv2

        return cv2.resize(img, (self.new_w, self.new_h), interpolation=cv2.INTER_LINEAR)

    def apply_mask(self, mask):
        import cv2

        return cv2.resize(mask, (self.new_w, self.new_h), interpolation=cv2.INTER_NEAREST)

    def out_size(self, h, w):
        return self.new_h, self.new_w


class FlipTransform(ClipTransform):
    def apply_image(self, img):
        return np.ascontiguousarray(img[:, ::-1])

    apply_mask = apply_image


class CropTransform(ClipTransform):
    def __init__(self, y0: int, x0: int, h: int, w: int):
        self.y0, self.x0, self.h, self.w = y0, x0, h, w

    def apply_image(self, img):
        return img[self.y0:self.y0 + self.h, self.x0:self.x0 + self.w]

    apply_mask = apply_image

    def out_size(self, h, w):
        return self.h, self.w


class Identity(ClipTransform):
    def apply_image(self, img):
        return img

    apply_mask = apply_image


class ResizeShortestEdge:
    """The shorter edge to one of ``min_sizes`` (``choice``) or a size in
    their range (``range``), the longer at most ``max_size``."""

    def __init__(self, min_sizes: Sequence[int], max_size: int, sample_style: str = "choice"):
        self.min_sizes, self.max_size, self.sample_style = list(min_sizes), max_size, sample_style

    def sample(self, h, w, rng: random.Random) -> ClipTransform:
        if self.sample_style == "range":
            size = rng.randint(min(self.min_sizes), max(self.min_sizes))
        else:
            size = rng.choice(self.min_sizes)
        scale = size / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        return ResizeTransform(int(round(h * scale)), int(round(w * scale)))


class RandomFlip:
    """A horizontal flip of the whole clip with probability ``prob``."""

    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def sample(self, h, w, rng: random.Random) -> ClipTransform:
        return FlipTransform() if rng.random() < self.prob else Identity()


class RandomCrop:
    """detectron2's ``relative_range`` crop: each side at least ``crop_size``
    of the image's."""

    def __init__(self, crop_size: Tuple[float, float]):
        self.crop_size = crop_size

    def sample(self, h, w, rng: random.Random) -> ClipTransform:
        ch = int(h * (self.crop_size[0] + rng.random() * (1 - self.crop_size[0])))
        cw = int(w * (self.crop_size[1] + rng.random() * (1 - self.crop_size[1])))
        y0 = rng.randint(0, max(h - ch, 0))
        x0 = rng.randint(0, max(w - cw, 0))
        return CropTransform(y0, x0, ch, cw)


def build_train_augmentation(cfg_input) -> list:
    """A clip flip (unless ``random_flip`` is ``none``), the shortest-edge
    resize, and the crop where ``crop_enabled``."""
    augs = []
    if cfg_input.random_flip != "none":
        augs.append(RandomFlip())
    augs.append(ResizeShortestEdge(cfg_input.min_size_train, cfg_input.max_size_train))
    if cfg_input.crop_enabled:
        augs.append(RandomCrop((0.8, 0.8)))
    return augs


def sample_clip_transforms(augs, h: int, w: int, rng: random.Random) -> List[ClipTransform]:
    """Draw the chain in order, each augmentation seeing the size the ones
    before it give."""
    ts = []
    for aug in augs:
        t = aug.sample(h, w, rng)
        ts.append(t)
        h, w = t.out_size(h, w)
    return ts


def apply_clip_transforms(transforms: List[ClipTransform], frames: List[np.ndarray],
                          masks_per_frame: Optional[List[List[np.ndarray]]] = None):
    """(frames, masks_per_frame) with every transform applied in order."""
    out_frames, out_masks = [], [] if masks_per_frame is not None else None
    for fi, img in enumerate(frames):
        for t in transforms:
            img = t.apply_image(img)
        out_frames.append(img)
        if masks_per_frame is not None:
            ms = []
            for m in masks_per_frame[fi]:
                for t in transforms:
                    m = t.apply_mask(m)
                ms.append(m)
            out_masks.append(ms)
    return out_frames, out_masks
