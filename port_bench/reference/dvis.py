"""DVIS++ offline (segmenter, referring tracker, temporal refiner) at inference, plain.

The module tree and parameter names are those of the benchmarked package's
``DVISOffline`` (``backbone.*``, ``sem_seg_head.{pixel_decoder,predictor}.*``,
``tracker.*``, ``refiner.*``), so one state dict loads into both. Only the
DINOv2 ViT-Adapter backbone and the MSDeformAttn pixel decoder are here: what
the benchmark's configurations use. Everything computes in fp32, or in the
control's fp8 (``layers.set_precision``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from port_bench.reference.decoder import MaskedTransformerDecoder
from port_bench.reference.deform import MSDeformAttnPixelDecoder
from port_bench.reference.refiner import TemporalRefiner
from port_bench.reference.tracker import ReferringTracker, TrackerState
from port_bench.reference.vit_adapter import build_vit_adapter


class _Head(nn.Module):
    def __init__(self, mcfg, in_channels: Dict[str, int]):
        super().__init__()
        pd, td = mcfg.pixel_decoder, mcfg.transformer_decoder
        self.pixel_decoder = MSDeformAttnPixelDecoder(in_channels, pd)
        self.predictor = MaskedTransformerDecoder(
            num_classes=mcfg.num_classes, in_channels=pd.conv_dim, hidden_dim=td.hidden_dim,
            num_queries=td.num_queries, num_heads=td.nheads, dim_feedforward=td.dim_feedforward,
            num_layers=td.dec_layers, mask_dim=td.mask_dim, reid_branch=td.reid_branch,
            reid_hidden_dim=td.reid_hidden_dim)


class DVISOfflineReference(nn.Module):
    def __init__(self, mcfg):
        """mcfg: the configuration's ``model`` section."""
        super().__init__()
        if mcfg.backbone.name != "vit_adapter_dinov2" or mcfg.pixel_decoder.name != "msdeform":
            raise NotImplementedError("the reference holds the ViT-Adapter and the MSDeformAttn "
                                      "pixel decoder only")
        td = mcfg.transformer_decoder
        C2 = td.hidden_dim * (2 if td.reid_branch else 1)
        self.backbone = build_vit_adapter(mcfg.backbone)
        self.sem_seg_head = _Head(mcfg, self.backbone.out_channels)
        self.tracker = ReferringTracker(
            num_classes=mcfg.num_classes, hidden_dim=C2, feedforward_dim=mcfg.tracker.feedforward_dim,
            num_heads=mcfg.tracker.num_heads, num_layers=mcfg.tracker.num_layers,
            mask_dim=td.hidden_dim, mask_in_dim=mcfg.pixel_decoder.mask_dim)
        self.refiner = TemporalRefiner(
            num_classes=mcfg.num_classes, hidden_dim=C2, feedforward_dim=mcfg.refiner.feedforward_dim,
            num_heads=mcfg.refiner.num_heads, num_layers=mcfg.refiner.num_layers,
            mask_dim=td.hidden_dim)

    def segment(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images (BT, 3, H, W) normalized -> the frame predictions."""
        features = self.backbone(images)
        mask_features, multi_scale = self.sem_seg_head.pixel_decoder(features)
        return self.sem_seg_head.predictor(multi_scale, mask_features)

    def online_step(self, images: torch.Tensor, state: TrackerState):
        """One window (1, Tw, 3, H, W): (tracker outputs, frame embeds without
        norm (1, Tw, Q, C2), mask features (1, Tw, Cm, H4, W4), state)."""
        B, T = images.shape[:2]
        seg = self.segment(images.flatten(0, 1))
        C2 = seg["pred_embds"].shape[-1]
        mf = seg["mask_features"]
        frame_nn = seg["pred_embds_without_norm"].reshape(B, T, -1, C2)
        track, state = self.tracker(seg["pred_embds"].reshape(B, T, -1, C2),
                                    mf.reshape(B, T, *mf.shape[1:]), frame_nn, state,
                                    predict_masks=False)
        return track, frame_nn, mf.reshape(B, T, *mf.shape[1:]), state
