"""DVIS++ offline meta-architecture: frozen segmenter + frozen tracker +
temporal refiner; its training forward and loss (stage 3 of the recipe).

Counterpart: ``dvis_plus_tpu/models/meta/dvis_offline.py::DVISOffline``
(:46-125: ``__call__`` with its training forward :66-90, ``online_step``,
``refine``, ``refine_embeds``, ``refine_mask_window``), ``_flatten_clip``
:128 and ``dvis_offline_train_loss`` :135. The JAX module nests the online stack under
``online``; here the class extends the port's ``DVISOnline`` and adds a
``refiner`` child, so the state dict stays in the reference checkpoints'
flat key space (``backbone.*``, ``sem_seg_head.*``, ``tracker.*``,
``refiner.*``). The refiner consumes the tracker's embeds, the segmenter's
un-normed frame embeds and the segmenter's raw mask features.

Training (:meth:`DVISOffline.train_forward`, :func:`dvis_offline_train_loss`):
the online stack runs without gradients and without the tracker's noise,
then the refiner over the whole clip with every layer's predictions. The
loss treats a clip as one tall (T*H, W) image: one clip-level matching with
``num_points x T`` points; while ``use_matcher_guidance`` (the first half of
training) the tracker's time-averaged logits and its masks drive one
assignment for every layer, after it each layer is matched on its own
outputs; then the class-memory ReID loss (``losses.reid``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from dvis_plus_tpu_torch.losses.criterion import LayerOutputs, layer_losses, match, match_coords
from dvis_plus_tpu_torch.losses.reid import ClassMemory, reid_loss_with_memory
from dvis_plus_tpu_torch.losses.targets import VideoTargets
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

    def train_forward(self, images: torch.Tensor) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """The training forward (``__call__`` with ``training``): the frozen
        segmenter and tracker without gradients (the JAX module's
        ``stop_gradient``) and without the tracker's noise, then the refiner
        with every layer's predictions. images (B, T, 3, H, W) normalized.
        Returns (track_out, refine_out)."""
        with torch.no_grad():
            _, track_out, frame_embds, mf, _ = self._online(images, None, True)
        refine_out = self.refiner(track_out["pred_embds"], frame_embds, mf, training=True)
        return track_out, refine_out

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


def _flatten_clip(masks: torch.Tensor) -> torch.Tensor:
    """(..., T, H, W) -> (..., 1, T*H, W): a clip as one tall image."""
    *lead, T, H, W = masks.shape
    return masks.reshape(*lead, 1, T * H, W)


def dvis_offline_train_loss(track_out: Dict[str, Any], refine_out: Dict[str, Any],
                            targets: VideoTargets, ccfg, use_matcher_guidance: bool, draws,
                            memory: Optional[ClassMemory], num_masks: Optional[torch.Tensor] = None
                            ) -> Tuple[Dict[str, torch.Tensor], Optional[ClassMemory]]:
    """The offline stage's losses, the ReID ones against the class memory
    included (none without a memory: DVIS-DAQ's offline stage, the JAX
    ``use_cl=False``), and the memory after this step. ``num_masks``
    divides the mask losses (default: the batch's instances, at least 1). The final
    layer's matching draws its points once (site ``("match", "final")``),
    for the guided and the self matching alike, as the JAX function uses
    one key for both."""
    B, N, T = targets.masks.shape[:3]
    ccfg = ccfg._replace(match_mode="clip", num_points=ccfg.num_points * T)
    if num_masks is None:
        num_masks = targets.num_instances().sum().float().clamp(min=1.0)
    flat = VideoTargets(targets.labels, _flatten_clip(targets.masks), targets.valid,
                        targets.valid[..., None])

    def flat_layer(logits, masks):
        # the refiner's logits are the time-pooled ones, repeated a frame
        return LayerOutputs(logits[:, 0], _flatten_clip(masks))

    outputs = flat_layer(refine_out["pred_logits"], refine_out["pred_masks"])
    aux = [flat_layer(lg, mk) for lg, mk in zip(refine_out["aux_pred_logits"],
                                                refine_out["aux_pred_masks"])]
    coords = match_coords(draws, "final", outputs, ccfg)
    if use_matcher_guidance:
        guided = LayerOutputs(track_out["pred_logits"].mean(dim=1),
                              _flatten_clip(track_out["pred_masks"]))
        q4g = match(guided, flat, ccfg, coords)
    else:
        q4g = match(outputs, flat, ccfg, coords)
    losses = layer_losses(outputs, flat, q4g, num_masks, ccfg, draws, "final")
    for i, a in enumerate(aux):
        q4g_aux = q4g if use_matcher_guidance else match(a, flat, ccfg,
                                                         match_coords(draws, i, a, ccfg))
        losses.update(layer_losses(a, flat, q4g_aux, num_masks, ccfg, draws, i, f"_{i}"))
    if memory is None:
        return losses, None
    cl, memory = reid_loss_with_memory(refine_out["pred_embds"], q4g, targets.valid,
                                       targets.labels, memory)
    losses["loss_reid"] = 2.0 * cl["loss_reid"]
    losses["loss_aux_reid"] = 3.0 * cl["loss_aux_reid"]
    return losses, memory
