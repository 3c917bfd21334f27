"""Static-shape padded ground truth of a batch of clips.

Counterpart: ``dvis_plus_tpu/losses/targets.py::VideoTargets`` (:19). Ground
truth is padded to a fixed instance capacity N a clip with a validity mask,
and an instance absent from a frame has an empty mask there (the reference's
``ids == -1``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class VideoTargets(NamedTuple):
    """labels (B, N) int64, arbitrary where not ``valid``; masks (B, N, T, H, W)
    bool at the stride-4 prediction size, empty where an instance is absent;
    valid (B, N) bool, the slot holds an instance seen in some frame;
    frame_valid (B, N, T) bool, the instance is present in frame t."""

    labels: torch.Tensor
    masks: torch.Tensor
    valid: torch.Tensor
    frame_valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.labels.shape[1]

    @property
    def num_frames(self) -> int:
        return self.frame_valid.shape[2]

    def num_instances(self) -> torch.Tensor:
        """(B,) instances a clip."""
        return self.valid.sum(dim=1)

    def to(self, device) -> "VideoTargets":
        return VideoTargets(*(t.to(device, non_blocking=True) for t in self))
