"""Clip-consistent training augmentations (host-side numpy and cv2).

Counterpart: the training half of ``dvis_plus_tpu/data/augmentation.py``
(``ResizeShortestEdge`` :104, ``RandomFlip`` :119, ``RotationTransform`` /
``RandomRotation`` :55-75, :129-139, ``RandomCrop`` :139,
``build_train_augmentation`` :155, ``apply_clip_transforms`` :173,
``PadCropTransform`` :195, ``ResizeScaleClip`` :222, ``FixedSizeCropClip``
:242, ``ColorJitterTransform`` and the brightness, contrast and saturation
augmentations :256-304, ``sample_clip_transforms`` :308,
``build_pseudo_augmentation`` :319), the reference's clip transforms: one
set of random parameters is drawn a clip (from the mapper's
``random.Random``, in the JAX package's order of calls) and applied to every
frame and its masks, with the same cv2 calls and flags, so the frames are
bit-equal. cv2 is imported inside the calls.
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


class RotationTransform(ClipTransform):
    """A rotation about the image centre that expands the canvas to hold the
    whole rotated image (bilinear for images, nearest for masks, zeros
    outside)."""

    def __init__(self, h: int, w: int, angle: float):
        import cv2

        self.angle = angle
        center = ((w - 1) / 2, (h - 1) / 2)
        M = cv2.getRotationMatrix2D(center, angle, 1.0)
        cos, sin = abs(M[0, 0]), abs(M[0, 1])
        nw, nh = int(round(h * sin + w * cos)), int(round(h * cos + w * sin))
        M[0, 2] += (nw - 1) / 2 - center[0]
        M[1, 2] += (nh - 1) / 2 - center[1]
        self.M, self.new_h, self.new_w = M, nh, nw

    def apply_image(self, img):
        import cv2

        return cv2.warpAffine(img, self.M, (self.new_w, self.new_h), flags=cv2.INTER_LINEAR)

    def apply_mask(self, mask):
        import cv2

        return cv2.warpAffine(mask, self.M, (self.new_w, self.new_h), flags=cv2.INTER_NEAREST)


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


class RandomRotation:
    """A rotation by an angle drawn uniformly in the range of ``angles``,
    with probability ``prob``."""

    def __init__(self, angles: Sequence[float], prob: float = 0.5):
        self.angles, self.prob = list(angles), prob

    def sample(self, h, w, rng: random.Random) -> ClipTransform:
        if rng.random() >= self.prob:
            return Identity()
        return RotationTransform(h, w, rng.uniform(min(self.angles), max(self.angles)))


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


class PadCropTransform(ClipTransform):
    """A fixed window cropped, then padded at the bottom and the right to
    the window's size (images with ``pad_value``, masks with 0)."""

    def __init__(self, y0: int, x0: int, out_h: int, out_w: int, pad_value: int = 128):
        self.y0, self.x0, self.out_h, self.out_w, self.pad_value = y0, x0, out_h, out_w, pad_value

    def _crop_pad(self, arr, pad_value):
        crop = arr[self.y0:self.y0 + self.out_h, self.x0:self.x0 + self.out_w]
        ph, pw = self.out_h - crop.shape[0], self.out_w - crop.shape[1]
        if ph or pw:
            crop = np.pad(crop, ((0, ph), (0, pw)) + ((0, 0),) * (arr.ndim - 2),
                          constant_values=pad_value)
        return crop

    def apply_image(self, img):
        return self._crop_pad(img, self.pad_value)

    def apply_mask(self, mask):
        return self._crop_pad(mask, 0)

    def out_size(self, h, w):
        return self.out_h, self.out_w


class ResizeScaleClip:
    """Large-scale jitter's resize: a scale drawn in [min, max] a clip, the
    image resized to fit the scaled target box, its aspect kept."""

    def __init__(self, min_scale: float, max_scale: float, target_height: int, target_width: int):
        self.min_scale, self.max_scale = min_scale, max_scale
        self.target_h, self.target_w = target_height, target_width

    def sample(self, h, w, rng: random.Random) -> ClipTransform:
        scale = rng.uniform(self.min_scale, self.max_scale)
        out_scale = min(self.target_h * scale / h, self.target_w * scale / w)
        return ResizeTransform(max(int(round(h * out_scale)), 1), max(int(round(w * out_scale)), 1))


class FixedSizeCropClip:
    """Large-scale jitter's crop: one window of ``crop_size`` a clip, padded
    where the image is smaller."""

    def __init__(self, crop_size, pad_value: int = 128):
        (self.crop_h, self.crop_w), self.pad_value = crop_size, pad_value

    def sample(self, h, w, rng: random.Random) -> ClipTransform:
        y0 = rng.randint(0, max(h - self.crop_h, 0)) if h > self.crop_h else 0
        x0 = rng.randint(0, max(w - self.crop_w, 0)) if w > self.crop_w else 0
        return PadCropTransform(y0, x0, self.crop_h, self.crop_w, self.pad_value)


class ColorJitterTransform(ClipTransform):
    """A linear intensity change of the image (masks untouched): ``scale``
    and ``offset``, then a blend with the grey mean by ``saturation``,
    clipped to [0, 255] in the image's dtype."""

    def __init__(self, scale: float = 1.0, offset: float = 0.0, saturation: float = 1.0):
        self.scale, self.offset, self.saturation = scale, offset, saturation

    def apply_image(self, img):
        out = img.astype(np.float32) * self.scale + self.offset
        if self.saturation != 1.0:
            gray = out.mean(axis=-1, keepdims=True)
            out = gray + (out - gray) * self.saturation
        return np.clip(out, 0, 255).astype(img.dtype)

    def apply_mask(self, mask):
        return mask


class RandomBrightness:
    """Intensities multiplied by a factor drawn in [lo, hi]."""

    def __init__(self, lo: float = 0.9, hi: float = 1.1):
        self.lo, self.hi = lo, hi

    def sample(self, h, w, rng: random.Random) -> ClipTransform:
        return ColorJitterTransform(scale=rng.uniform(self.lo, self.hi))


class RandomContrast:
    """A blend with the mid-grey 128 by a factor drawn in [lo, hi]."""

    def __init__(self, lo: float = 0.9, hi: float = 1.1):
        self.lo, self.hi = lo, hi

    def sample(self, h, w, rng: random.Random) -> ClipTransform:
        f = rng.uniform(self.lo, self.hi)
        return ColorJitterTransform(scale=f, offset=128.0 * (1.0 - f))


class RandomSaturation:
    """A blend with the pixel's grey mean by a factor drawn in [lo, hi]."""

    def __init__(self, lo: float = 0.9, hi: float = 1.1):
        self.lo, self.hi = lo, hi

    def sample(self, h, w, rng: random.Random) -> ClipTransform:
        return ColorJitterTransform(saturation=rng.uniform(self.lo, self.hi))


def build_pseudo_augmentation(cfg_input) -> list:
    """The pseudo-video recipe's chain (the rotation is the pseudo-video
    mapper's, a frame at a time): a clip flip unless ``random_flip`` is
    ``none``; brightness, contrast and saturation as
    ``input.augmentations`` names them; then with ``input.lsj_aug`` the
    large-scale jitter (scale 0.1 to 2 of a ``max_size_train`` square, then
    that square cropped), else the shortest-edge resize."""
    augs = []
    if cfg_input.random_flip != "none":
        augs.append(RandomFlip())
    extra = set(cfg_input.augmentations or ())
    for name, aug in (("brightness", RandomBrightness), ("contrast", RandomContrast),
                      ("saturation", RandomSaturation)):
        if name in extra:
            augs.append(aug())
    if cfg_input.lsj_aug:
        size = cfg_input.max_size_train
        augs += [ResizeScaleClip(0.1, 2.0, size, size), FixedSizeCropClip((size, size))]
    else:
        augs.append(ResizeShortestEdge(cfg_input.min_size_train, cfg_input.max_size_train))
    return augs
