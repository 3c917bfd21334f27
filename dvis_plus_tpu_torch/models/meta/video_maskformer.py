"""Video Mask2Former (the clip-level pretraining meta-architecture) and the
image Mask2Former, with their training loss.

Counterpart: ``dvis_plus_tpu/models/meta/video_maskformer.py`` (``VideoMaskFormer``
:29-69, ``video_maskformer_train_loss`` :71-85, ``ImageMaskFormer`` :88-95):
backbone and pixel decoder per frame, then the clip-joint query decoder
(:class:`~dvis_plus_tpu_torch.models.segmenter.clip_decoder.ClipMaskedTransformerDecoder`)
over the whole clip. The module holds its weights under the reference
checkpoints' names (``backbone.*``, ``sem_seg_head.pixel_decoder.*``,
``sem_seg_head.predictor.*``). ``ImageMaskFormer`` (the COCO image
pretraining model) is the same module on one-frame clips. Training matches
each clip's instances to the queries once over the whole clip
(``match_mode="clip"``), the final prediction and every earlier one.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from dvis_plus_tpu_torch.losses.criterion import CriterionConfig, LayerOutputs, video_criterion
from dvis_plus_tpu_torch.losses.targets import VideoTargets
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

    def forward(self, images: torch.Tensor, aux: bool = False, draws=None) -> Dict[str, Any]:
        """images: (B, T, 3, H, W) normalized. Clip-level predictions:
        ``pred_logits`` (B, Q, K+1), ``pred_masks`` (B, Q, T, H4, W4); with
        ``aux`` every earlier prediction too. ``draws``: the training step's,
        for the backbone."""
        B, T = images.shape[:2]
        cdt = self.compute_dtype
        features = self.backbone(images.flatten(0, 1).to(cdt), draws=draws)
        mask_features, multi_scale = self.sem_seg_head.pixel_decoder(features)
        return self.sem_seg_head.predictor(
            [m.to(cdt) for m in multi_scale], mask_features.to(cdt), num_frames=T, aux=aux
        )


class ImageMaskFormer(VideoMaskFormer):
    """The image Mask2Former: the video model with one frame. A 4-D input
    (B, 3, H, W) is B clips of one frame; a 5-D input is taken as it is (the
    eval loop hands it a whole video as one clip, as the JAX loop does)."""

    def forward(self, images: torch.Tensor, aux: bool = False, draws=None) -> Dict[str, Any]:
        if images.dim() == 4:
            images = images[:, None]
        return super().forward(images, aux=aux, draws=draws)


def video_maskformer_train_loss(out: Dict[str, Any], targets: VideoTargets, ccfg: CriterionConfig,
                                draws) -> Dict[str, torch.Tensor]:
    """The clip criterion over the final and every auxiliary prediction of
    a clip model (``out`` with ``aux``): one matching a clip and layer
    (``match_mode="clip"``), the losses over the clips' instances."""
    outputs = LayerOutputs(out["pred_logits"], out["pred_masks"])
    aux = [LayerOutputs(lg, mk) for lg, mk in zip(out["aux_pred_logits"], out["aux_pred_masks"])]
    losses, _ = video_criterion(outputs, aux, targets, ccfg._replace(match_mode="clip"), draws)
    return losses
