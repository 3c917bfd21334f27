"""OV-DVIS++ meta-architectures (open vocabulary), inference path.

Counterpart: ``dvis_plus_tpu/models/meta/ov.py`` (``OVSegmenter`` :38 with
``full_classifier`` :82, ``pool_clip`` :150 and ``clip_logit_scale``;
``DVISOnlineOV`` :163; ``DVISOfflineOV`` :230 with ``online_forward``,
``refine_embeds``, ``refine_mask_window``, ``refine_ov_classify``;
``ov_ensemble_inference`` :315):

- the segmenter is the frozen CLIP trunk (ConvNeXt or RN50,
  ``models/ov/clip_backbone.py``), the MSDeformAttn pixel decoder (kernel B1
  on the card) and the FC-CLIP query decoder;
- the text classifier (host numpy, ``models/ov/text.py``) comes in as a
  tensor; the learned void rows (``void_embedding.weight``, and one row a
  further training dataset in ``additional_void_embedding.weight``) are
  normalized and appended by :meth:`OVSegmenter.full_classifier`;
- the tracker and refiner are the port's, with their ``ov`` heads;
- :func:`ov_ensemble_inference` scores the CLIP embeddings pooled under the
  predicted masks and fuses them with the model's logits
  (``heads.geometric_ensemble``).

The JAX module nests the online stack under ``online``; here the offline
class extends the online one, which extends the segmenter, so the state
dict is the reference checkpoints' flat key space (``backbone.clip_model.*``,
``sem_seg_head.*``, ``void_embedding.weight``, ``tracker.*``,
``refiner.*``), which ``core/zoo_convert.py::convert_reference_checkpoint``
routes for ``minvis_ov``, ``dvis_online_ov`` and ``dvis_offline_ov``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from dvis_plus_tpu_torch.models.ov.clip_backbone import CLIPBackbone
from dvis_plus_tpu_torch.models.ov.heads import geometric_ensemble, get_classification_logits
from dvis_plus_tpu_torch.models.refiner.temporal_refiner import TemporalRefiner
from dvis_plus_tpu_torch.models.segmenter.pixel_decoder import dtype_of
from dvis_plus_tpu_torch.models.segmenter.segmenter import MaskFormerHead
from dvis_plus_tpu_torch.models.tracker.referring_tracker import ReferringTracker, TrackerState


class OVSegmenter(nn.Module):
    """CLIP backbone + pixel decoder + FC-CLIP query decoder (the MinVIS_OV
    model, and the first stage of the DVIS OV models). ``cfg``: a model
    config (``cfg.model``)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        self.backbone = CLIPBackbone(cfg)
        self.sem_seg_head = MaskFormerHead(cfg, self.backbone.out_channels, ov=True)
        n, Cc = cfg.ov.num_void_embeddings, cfg.ov.clip_embed_dim
        self.void_embedding = nn.Embedding(1, Cc)
        self.additional_void_embedding = nn.Embedding(n - 1, Cc) if n > 1 else None

    def full_classifier(self, text_classifier: torch.Tensor,
                        void_index: Optional[int] = None) -> torch.Tensor:
        """The text classifier with the void row(s) appended, normalized:
        ``void_index=i`` appends dataset i's private row; ``None`` merges the
        rows by ``ov.void_merge_mode`` (``coco``: row 0, ``mean``: the mean
        row, ``max``: every row, max-ensembled downstream as one group)."""
        v = self.void_embedding.weight
        if self.additional_void_embedding is not None:
            v = torch.cat([v, self.additional_void_embedding.weight])
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
        if void_index is not None:
            rows = v[int(void_index) : int(void_index) + 1]
        else:
            mode = self.cfg.ov.void_merge_mode
            if mode == "mean":
                rows = v.mean(dim=0, keepdim=True)
            elif mode == "max":
                rows = v
            elif mode == "coco":
                rows = v[:1]
            else:
                raise NotImplementedError(mode)
        return torch.cat([text_classifier, rows.to(text_classifier.dtype)])

    def with_void(self, text_classifier: torch.Tensor, num_templates: Sequence[int],
                  void_index: Optional[int] = None) -> torch.Tensor:
        """``text_classifier`` with its void rows, unless it has them already
        (fewer rows than ``sum(num_templates)`` means it has not)."""
        if text_classifier.shape[0] < sum(num_templates):
            return self.full_classifier(text_classifier, void_index)
        return text_classifier

    def forward(self, images: torch.Tensor, text_classifier: torch.Tensor,
                num_templates: Sequence[int], void_index: Optional[int] = None) -> Dict[str, Any]:
        """images (BT, 3, H, W) normalized -> the per-frame dict, with the
        stride-32 CLIP features (``clip_vis_dense``)."""
        tc = self.with_void(text_classifier, num_templates, void_index)
        cdt = self.compute_dtype
        features = self.backbone(images.to(cdt))
        mask_features, multi_scale = self.sem_seg_head.pixel_decoder(
            {k: v for k, v in features.items() if k.startswith("res")})
        out = self.sem_seg_head.predictor([m.to(cdt) for m in multi_scale], mask_features.to(cdt),
                                          text_classifier=tc, num_templates=num_templates)
        out["clip_vis_dense"] = features["clip_vis_dense"]
        return out

    def pool_clip(self, clip_dense: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """Out-of-vocabulary head: (B, N, clip_embed_dim) CLIP embeddings of
        the masks (B, N, Hm, Wm) over the stride-32 features."""
        return self.backbone.pool_clip(clip_dense, masks)

    def clip_logit_scale(self) -> torch.Tensor:
        return self.backbone.logit_scale


class DVISOnlineOV(OVSegmenter):
    """OV segmenter + OV referring tracker (``tracker.*``)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        td = cfg.transformer_decoder
        self.tracker = ReferringTracker(
            num_classes=0,
            hidden_dim=td.hidden_dim,
            feedforward_dim=cfg.tracker.feedforward_dim,
            num_heads=cfg.tracker.num_heads,
            num_layers=cfg.tracker.num_layers,
            mask_dim=td.hidden_dim,
            mask_in_dim=cfg.pixel_decoder.mask_dim,
            matcher=cfg.tracker.matcher_solver,
            ov=True,
            clip_embed_dim=cfg.ov.clip_embed_dim,
        )

    def forward(self, images: torch.Tensor, text_classifier: torch.Tensor,
                num_templates: Sequence[int], state: Optional[TrackerState] = None,
                void_index: Optional[int] = None, predict_masks: bool = True,
                ) -> Tuple[Dict[str, Any], Dict[str, Any], TrackerState]:
        """images (B, T, 3, H, W) normalized -> (seg_out, track_out, state).
        Without ``predict_masks`` the tracker gives no masks and so no class
        logits (the offline path needs neither)."""
        B, T = images.shape[:2]
        tc = self.with_void(text_classifier, num_templates, void_index)
        seg_out = super().forward(images.flatten(0, 1), tc, num_templates)
        C = seg_out["pred_embds"].shape[-1]
        mf = seg_out["mask_features"]
        track_out, new_state = self.tracker(
            seg_out["pred_embds"].reshape(B, T, -1, C),
            mf.reshape(B, T, *mf.shape[1:]),
            frame_embeds_no_norm=seg_out["pred_embds_without_norm"].reshape(B, T, -1, C),
            state=state,
            predict_masks=predict_masks,
            text_classifier=tc,
            num_templates=num_templates,
        )
        return seg_out, track_out, new_state


class DVISOfflineOV(DVISOnlineOV):
    """+ the OV temporal refiner (``refiner.*``)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        td = cfg.transformer_decoder
        self.refiner = TemporalRefiner(
            num_classes=0,
            hidden_dim=td.hidden_dim,
            feedforward_dim=cfg.refiner.feedforward_dim,
            num_heads=cfg.refiner.num_heads,
            num_layers=cfg.refiner.num_layers,
            mask_dim=td.hidden_dim,
            ov=True,
            clip_embed_dim=cfg.ov.clip_embed_dim,
        )

    def forward(self, images: torch.Tensor, text_classifier: torch.Tensor,
                num_templates: Sequence[int], state: Optional[TrackerState] = None,
                void_index: Optional[int] = None):
        """Whole clip in one pass: (seg_out, track_out, refine_out, state)."""
        B, T = images.shape[:2]
        tc = self.with_void(text_classifier, num_templates, void_index)
        seg_out, track_out, new_state = super().forward(images, tc, num_templates, state)
        C = seg_out["pred_embds_without_norm"].shape[-1]
        mf = seg_out["mask_features"]
        refine_out = self.refiner(
            track_out["pred_embds"], seg_out["pred_embds_without_norm"].reshape(B, T, -1, C),
            mf.reshape(B, T, *mf.shape[1:]), tc, num_templates)
        return seg_out, track_out, refine_out, new_state

    def online_step(self, images: torch.Tensor, text_classifier: torch.Tensor,
                    num_templates: Sequence[int], state: Optional[TrackerState] = None,
                    void_index: Optional[int] = None):
        """One streaming window of segmenter + tracker, without the tracker's
        heads. Returns (instance embeds (B, T, Q, C), frame embeds (B, T, fQ,
        C), mask features (B, T, Cm, H4, W4), CLIP features (B·T, Cc', h, w),
        state)."""
        B, T = images.shape[:2]
        seg_out, track_out, new_state = super().forward(
            images, text_classifier, num_templates, state, void_index, predict_masks=False)
        C = seg_out["pred_embds_without_norm"].shape[-1]
        mf = seg_out["mask_features"]
        return (track_out["pred_embds"], seg_out["pred_embds_without_norm"].reshape(B, T, -1, C),
                mf.reshape(B, T, *mf.shape[1:]), seg_out["clip_vis_dense"], new_state)

    def refine_embeds(self, instance_embeds, frame_embeds, time_mask=None):
        """Embeds-only refiner pass: ``fused`` and ``mask_embed``."""
        return self.refiner.embed_pass(instance_embeds, frame_embeds, time_mask)

    def refine_mask_window(self, mask_embed, mask_features):
        """Mask head on one time window (B, Tw, ...) -> (B, Q, Tw, H, W)."""
        return self.refiner.mask_window(mask_embed, mask_features)

    def refine_ov_classify(self, fused, pooled, text_classifier, num_templates,
                           void_index: Optional[int] = None):
        """Video-level in-vocabulary logits (B, Q, K+1) from the refiner's
        ``fused`` and the window-accumulated mask pooling."""
        tc = self.with_void(text_classifier, num_templates, void_index)
        return self.refiner.ov_classify(fused, pooled, tc, num_templates)


def ov_ensemble_inference(
    in_vocab_logits: torch.Tensor,  # (T, Q, K+1) from the model
    pooled_clip_embeds: Optional[torch.Tensor],  # (T, Q, Cc) pool_clip output
    text_classifier: torch.Tensor,  # with the void rows
    num_templates: Sequence[int],
    logit_scale: torch.Tensor,
    category_overlapping: torch.Tensor,  # (K,)
    alpha: float = 0.4,
    beta: float = 0.8,
    out_vocab_logits: Optional[torch.Tensor] = None,  # precomputed (T, Q, K+1)
) -> torch.Tensor:
    """Fused (T, Q, K+1) log-probabilities: the out-of-vocabulary CLIP logits
    (from ``pooled_clip_embeds``, or given) through the geometric ensemble."""
    if out_vocab_logits is None:
        out_vocab_logits = get_classification_logits(
            pooled_clip_embeds, text_classifier, logit_scale, num_templates)
    return geometric_ensemble(in_vocab_logits, out_vocab_logits, category_overlapping, alpha, beta)
