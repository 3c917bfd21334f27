"""Video Mask2Former (the clip-level pretraining meta-architecture) and the
image Mask2Former, inference path.

Counterpart: ``dvis_plus_tpu/models/meta/video_maskformer.py::VideoMaskFormer``
(:29-69): backbone and pixel decoder per frame, then the clip-joint query
decoder (:class:`~dvis_plus_tpu_torch.models.segmenter.clip_decoder.ClipMaskedTransformerDecoder`)
over the whole clip. The module holds its weights under the reference
checkpoints' names (``backbone.*``, ``sem_seg_head.pixel_decoder.*``,
``sem_seg_head.predictor.*``). ``ImageMaskFormer`` (:89-95, the COCO image
pretraining model) is the same module on one-frame clips.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from dvis_plus_tpu_torch.models.segmenter.pixel_decoder import dtype_of
from dvis_plus_tpu_torch.models.segmenter.segmenter import MaskFormerHead, build_backbone


class VideoMaskFormer(nn.Module):
    def __init__(self, cfg):
        """cfg: a model config (``cfg.model`` of either config kind)."""
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        self.backbone = build_backbone(cfg)
        self.sem_seg_head = MaskFormerHead(cfg, self.backbone.out_channels, clip=True)

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        """images: (B, T, 3, H, W) normalized. Clip-level predictions:
        ``pred_logits`` (B, Q, K+1), ``pred_masks`` (B, Q, T, H4, W4)."""
        B, T = images.shape[:2]
        cdt = self.compute_dtype
        features = self.backbone(images.flatten(0, 1).to(cdt))
        mask_features, multi_scale = self.sem_seg_head.pixel_decoder(features)
        return self.sem_seg_head.predictor(
            [m.to(cdt) for m in multi_scale], mask_features.to(cdt), num_frames=T
        )


class ImageMaskFormer(VideoMaskFormer):
    """The image Mask2Former: the video model with one frame. A 4-D input
    (B, 3, H, W) is B clips of one frame; a 5-D input is taken as it is (the
    eval loop hands it a whole video as one clip, as the JAX loop does)."""

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        if images.dim() == 4:
            images = images[:, None]
        return super().forward(images)
