"""DVIS++ online meta-architecture: frozen segmenter + referring tracker,
inference path.

Counterpart: ``dvis_plus_tpu/models/meta/dvis_online.py`` (``DVISOnline``
:40, ``online_post_processing`` :180, ``inference_video_vis`` :192). The
module holds its weights under the reference checkpoints' names
(``backbone.*``, ``sem_seg_head.*``, ``tracker.*``); the embedding width
doubles with the ReID branch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from dvis_plus_tpu_torch.models.meta.minvis import topk_select, upsample_masks
from dvis_plus_tpu_torch.models.segmenter.segmenter import Segmenter
from dvis_plus_tpu_torch.models.tracker.referring_tracker import ReferringTracker, TrackerState


class DVISOnline(Segmenter):
    def __init__(self, cfg):
        """cfg: a model config (``cfg.model`` of either config kind)."""
        super().__init__(cfg)
        td = cfg.transformer_decoder
        self.tracker = ReferringTracker(
            num_classes=cfg.num_classes,
            hidden_dim=td.hidden_dim * (2 if td.reid_branch else 1),
            feedforward_dim=cfg.tracker.feedforward_dim,
            num_heads=cfg.tracker.num_heads,
            num_layers=cfg.tracker.num_layers,
            mask_dim=td.hidden_dim,
            mask_in_dim=cfg.pixel_decoder.mask_dim,
            matcher=cfg.tracker.matcher_solver,
        )

    def forward(
        self,
        images: torch.Tensor,  # (B, T, 3, H, W) normalized
        state: Optional[TrackerState] = None,
        predict_masks: bool = True,
    ) -> Tuple[Dict[str, Any], Dict[str, Any], TrackerState]:
        B, T = images.shape[:2]
        seg_out = super().forward(images.flatten(0, 1))
        C2 = seg_out["pred_embds"].shape[-1]
        mf = seg_out["mask_features"]
        track_out, new_state = self.tracker(
            seg_out["pred_embds"].reshape(B, T, -1, C2),
            mf.reshape(B, T, *mf.shape[1:]),
            frame_embeds_no_norm=seg_out["pred_embds_without_norm"].reshape(B, T, -1, C2),
            state=state,
            predict_masks=predict_masks,
        )
        return seg_out, track_out, new_state


def online_post_processing(pred_logits: torch.Tensor) -> torch.Tensor:
    """(T, Q, K+1) -> mean class logits over frames; ids are arange(Q)."""
    return pred_logits.mean(dim=0)


def inference_video_vis(mask_cls, mask_pred, img_size, output_size, padded_size, topk=20):
    """One-shot top-K VIS extraction: (scores, labels, (topk, T, out_h, out_w)
    bool masks). The eval loop pages the upsampling instead
    (``engine.inference.paged_inference_video``)."""
    scores, labels, queries = topk_select(mask_cls, topk)
    return scores, labels, upsample_masks(mask_pred[queries], img_size, output_size, padded_size)
