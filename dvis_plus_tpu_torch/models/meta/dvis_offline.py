"""DVIS++ offline meta-architecture: frozen segmenter + frozen tracker +
temporal refiner, inference methods.

Counterpart: ``dvis_plus_tpu/models/meta/dvis_offline.py::DVISOffline``
(:46-125: ``__call__``, ``online_step``, ``refine``, ``refine_embeds``,
``refine_mask_window``). The JAX module nests the online stack under
``online``; here the class extends the port's ``DVISOnline`` and adds a
``refiner`` child, so the state dict stays in the reference checkpoints'
flat key space (``backbone.*``, ``sem_seg_head.*``, ``tracker.*``,
``refiner.*``). The refiner consumes the tracker's embeds, the segmenter's
un-normed frame embeds and the segmenter's raw mask features. The training
loss is not ported (ROADMAP A14).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from dvis_plus_tpu_torch.models.meta.dvis_online import DVISOnline
from dvis_plus_tpu_torch.models.refiner.temporal_refiner import TemporalRefiner
from dvis_plus_tpu_torch.models.tracker.referring_tracker import TrackerState


class DVISOffline(DVISOnline):
    def __init__(self, cfg):
        """cfg: a model config (``cfg.model`` of either config kind)."""
        super().__init__(cfg)
        td = cfg.transformer_decoder
        self.refiner = TemporalRefiner(
            num_classes=cfg.num_classes,
            hidden_dim=td.hidden_dim * (2 if td.reid_branch else 1),
            feedforward_dim=cfg.refiner.feedforward_dim,
            num_heads=cfg.refiner.num_heads,
            num_layers=cfg.refiner.num_layers,
            mask_dim=td.hidden_dim,
        )

    def _online(self, images: torch.Tensor, state: Optional[TrackerState], predict_masks: bool):
        B, T = images.shape[:2]
        seg_out, track_out, new_state = super().forward(images, state, predict_masks)
        C2 = seg_out["pred_embds_without_norm"].shape[-1]
        frame_embds = seg_out["pred_embds_without_norm"].reshape(B, T, -1, C2)
        mf = seg_out["mask_features"]
        return seg_out, track_out, frame_embds, mf.reshape(B, T, *mf.shape[1:]), new_state

    def forward(
        self,
        images: torch.Tensor,  # (B, T, 3, H, W) normalized
        state: Optional[TrackerState] = None,
    ) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any], TrackerState]:
        """Whole clip in one pass: (seg_out, track_out, refine_out, state)."""
        seg_out, track_out, frame_embds, mf, new_state = self._online(images, state, True)
        refine_out = self.refiner(track_out["pred_embds"], frame_embds, mf)
        return seg_out, track_out, refine_out, new_state

    def online_step(self, images: torch.Tensor, state: Optional[TrackerState] = None):
        """One streaming window of segmenter + tracker. Returns (online logits
        (B, T, Q, K+1), instance embeds (B, T, Q, C2), frame embeds
        (B, T, fQ, C2), mask features (B, T, mask_dim, H4, W4), state)."""
        _, track_out, frame_embds, mf, new_state = self._online(images, state, False)
        return track_out["pred_logits"], track_out["pred_embds"], frame_embds, mf, new_state

    def refine(self, instance_embeds, frame_embeds, mask_features):
        """Whole-video refiner pass over the accumulated window outputs."""
        return self.refiner(instance_embeds, frame_embeds, mask_features)

    def refine_embeds(self, instance_embeds, frame_embeds, time_mask=None):
        """Embeds-only refiner pass; pair with :meth:`refine_mask_window`."""
        return self.refiner.embed_pass(instance_embeds, frame_embeds, time_mask)

    def refine_mask_window(self, mask_embed, mask_features):
        """Mask head on one time window (B, Tw, ...) -> (B, Q, Tw, H, W)."""
        return self.refiner.mask_window(mask_embed, mask_features)
