"""Segmenter = backbone + pixel decoder + masked-attention query decoder.

Counterpart: ``dvis_plus_tpu/models/segmenter/segmenter.py::Segmenter`` (:41).
Submodules carry the reference names ``backbone`` and
``sem_seg_head.{pixel_decoder,predictor}``, so a meta-architecture that
extends this class keeps the reference checkpoints' key space. The pixel
decoder's input projections take the widths the backbone reports
(``backbone.out_channels``), as the JAX module infers them from its
inputs. Input
(BT, 3, H, W) normalized images; the images are cast to
``model.compute_dtype`` before the backbone and the pixel decoder's outputs
before the query decoder, as in the JAX module (:81-89).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from dvis_plus_tpu_torch.models.backbones.resnet import resnet50, resnet101
from dvis_plus_tpu_torch.models.backbones.swin import build_swin
from dvis_plus_tpu_torch.models.backbones.vit_adapter import build_vit_adapter
from dvis_plus_tpu_torch.models.ov.ov_decoder import OVMaskedTransformerDecoder
from dvis_plus_tpu_torch.models.segmenter.clip_decoder import ClipMaskedTransformerDecoder
from dvis_plus_tpu_torch.models.segmenter.pixel_decoder import (
    MSDeformAttnPixelDecoder,
    dtype_of,
)
from dvis_plus_tpu_torch.models.segmenter.transformer_decoder import MaskedTransformerDecoder


def build_backbone(cfg) -> nn.Module:
    """cfg: a model config (``cfg.model`` of either config kind). The module
    reports its per-level output widths in ``out_channels``."""
    name = cfg.backbone.name
    if name == "resnet50":
        return resnet50(out_features=tuple(cfg.backbone.out_features))
    if name == "resnet101":
        return resnet101(out_features=tuple(cfg.backbone.out_features))
    if name.startswith("swin"):
        return build_swin(cfg.backbone)
    if name == "vit_adapter_dinov2":
        return build_vit_adapter(cfg.backbone)
    raise ValueError(f"backbone {name!r} is not ported yet")


class MaskFormerHead(nn.Module):
    """Container for the reference ``sem_seg_head`` key group. ``clip``: the
    clip-joint query decoder of Video Mask2Former, whose pixel decoder the
    JAX ``VideoMaskFormer`` builds without the ``msdeform_impl`` knob, so it
    is always the exact form there. ``ov``: the FC-CLIP query decoder of
    the open-vocabulary models (``models/ov/ov_decoder.py``)."""

    def __init__(self, cfg, in_channels: Dict[str, int], clip: bool = False, ov: bool = False):
        super().__init__()
        pd, td = cfg.pixel_decoder, cfg.transformer_decoder
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            in_channels=in_channels,
            conv_dim=pd.conv_dim,
            mask_dim=pd.mask_dim,
            num_enc_layers=pd.transformer_enc_layers,
            n_heads=pd.transformer_nheads,
            d_ffn=pd.transformer_dim_feedforward,
            n_points=pd.num_points,
            transformer_in_features=tuple(pd.transformer_in_features),
            value_dtype=pd.msdeform_value_dtype,
            island_dtype=pd.island_dtype,
            impl="exact" if clip else pd.msdeform_impl,
        )
        widths = dict(
            num_classes=cfg.num_classes,
            in_channels=pd.conv_dim,
            hidden_dim=td.hidden_dim,
            num_queries=td.num_queries,
            num_heads=td.nheads,
            dim_feedforward=td.dim_feedforward,
            num_layers=td.dec_layers,
            mask_dim=td.mask_dim,
        )
        if clip:
            self.predictor = ClipMaskedTransformerDecoder(**widths)
        elif ov:
            del widths["num_classes"]
            self.predictor = OVMaskedTransformerDecoder(clip_embed_dim=cfg.ov.clip_embed_dim, **widths)
        else:
            self.predictor = MaskedTransformerDecoder(
                **widths, reid_branch=td.reid_branch, reid_hidden_dim=td.reid_hidden_dim)


class Segmenter(nn.Module):
    """Frame-level Mask2Former segmenter (the frozen stage-1 model of DVIS)."""

    def __init__(self, cfg):
        """cfg: a model config (``cfg.model`` of either config kind)."""
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        self.backbone = build_backbone(cfg)
        self.sem_seg_head = MaskFormerHead(cfg, self.backbone.out_channels)

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        """images: (BT, 3, H, W) normalized. Returns the per-frame dict."""
        cdt = self.compute_dtype
        features = self.backbone(images.to(cdt))
        mask_features, multi_scale = self.sem_seg_head.pixel_decoder(features)
        return self.sem_seg_head.predictor(
            [m.to(cdt) for m in multi_scale], mask_features.to(cdt)
        )
