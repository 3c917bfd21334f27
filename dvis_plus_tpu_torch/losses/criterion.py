"""Video set criterion: class cross-entropy, point-sampled sigmoid-CE and
dice, with deep supervision, over padded targets.

Counterpart: ``dvis_plus_tpu/losses/criterion.py`` (``CriterionConfig``
:38, ``LayerOutputs`` :52, ``_match`` :62, ``loss_labels`` :86,
``loss_masks`` :114, ``video_criterion`` :159), the reference
``VideoSetCriterion``:

- :func:`loss_labels`: cross-entropy with the no-object class weighted
  ``eos_coef`` for unmatched queries;
- :func:`loss_masks`: one row a (instance slot, frame); points importance
  sampled from the predicted logits (no gradient through the choice), then
  sigmoid-CE (mean over points) and dice, summed over valid rows and divided
  by ``num_masks``;
- :func:`video_criterion`: the final layer and every auxiliary layer, each
  re-matched on its own outputs unless another model's outputs drive the
  matching (``matcher_outputs``).

Every random point set comes from ``draws`` (:mod:`utils.draws`) under the
site ``("match", layer)`` or ``("points", layer, "over" | "fill")``, layer
``"final"`` or an auxiliary layer's index. Under data parallelism the
divisors (``num_masks``, the cross-entropy's weight sum) are the whole
batch's (``parallel.mesh.global_sum``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from dvis_plus_tpu_torch.losses.matcher import MatchCosts, consistent_match, video_hungarian_match
from dvis_plus_tpu_torch.losses.targets import VideoTargets
from dvis_plus_tpu_torch.ops.point_sample import point_sample, uncertain_point_coords_with_randomness
from dvis_plus_tpu_torch.parallel.mesh import global_sum


class CriterionConfig(NamedTuple):
    num_classes: int
    eos_coef: float = 0.1
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    match_mode: str = "clip"  # clip | frame_consistent
    matcher_solver: str = "jv"  # jv | auction

    def costs(self) -> MatchCosts:
        return MatchCosts(self.class_weight, self.mask_weight, self.dice_weight, self.num_points,
                          self.matcher_solver)


class LayerOutputs(NamedTuple):
    """One decoder layer's predictions: pred_logits (B, Q, K+1) clip-level
    or (B, T, Q, K+1) per frame; pred_masks (B, Q, T, H, W)."""

    pred_logits: torch.Tensor
    pred_masks: torch.Tensor


def match_coords(draws, layer, outputs: LayerOutputs, cfg: CriterionConfig) -> torch.Tensor:
    """The matcher's point sets for ``outputs``: (B, T, P, 2) a frame in
    ``frame_consistent`` mode, else (B, P, 2) a clip."""
    B, _, T = outputs.pred_masks.shape[:3]
    shape = (B, T, cfg.num_points, 2) if cfg.match_mode == "frame_consistent" else (B, cfg.num_points, 2)
    return draws.uniform(("match", layer), shape).to(outputs.pred_masks.device)


def match(outputs: LayerOutputs, targets: VideoTargets, cfg: CriterionConfig,
          coords: torch.Tensor) -> torch.Tensor:
    """query_for_gt (B, N) int64 on the outputs' device."""
    logits = outputs.pred_logits.detach()
    masks = outputs.pred_masks.detach()
    if cfg.match_mode == "frame_consistent":
        if logits.dim() != 4:
            raise ValueError("consistent matching needs per-frame logits")
        q4g = consistent_match(logits, masks.transpose(1, 2), targets, coords, cfg.costs())
    else:
        if logits.dim() == 4:  # per-frame logits: the clip's mean
            logits = logits.mean(dim=1)
        q4g = video_hungarian_match(logits, masks, targets, coords, cfg.costs())
    return q4g.to(outputs.pred_logits.device)


def loss_labels(pred_logits: torch.Tensor, targets: VideoTargets, query_for_gt: torch.Tensor,
                cfg: CriterionConfig) -> torch.Tensor:
    """Weighted cross-entropy; pred_logits (B, Q, K+1) or (B, T, Q, K+1)."""
    K, Q = cfg.num_classes, pred_logits.shape[-2]
    B = targets.labels.shape[0]
    target_classes = torch.full((B, Q + 1), K, dtype=torch.long, device=pred_logits.device)
    q_idx = torch.where(targets.valid, query_for_gt, torch.full_like(query_for_gt, Q))
    # a valid slot left unmatched (-1) wraps to the last query, as the JAX
    # scatter's index normalization does; invalid slots land in the dropped column Q
    q_idx = torch.where(q_idx < 0, q_idx + Q, q_idx)
    target_classes.scatter_(1, q_idx, targets.labels.long())
    target_classes = target_classes[:, :Q]
    if pred_logits.dim() == 4:
        target_classes = target_classes[:, None].expand(B, pred_logits.shape[1], Q)
    logp = F.log_softmax(pred_logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, target_classes[..., None])[..., 0]
    w = torch.where(target_classes == K, cfg.eos_coef, 1.0)
    return (nll * w).sum() / global_sum(w.sum()).clamp(min=1.0)


def loss_masks(pred_masks: torch.Tensor, targets: VideoTargets, query_for_gt: torch.Tensor,
               num_masks: torch.Tensor, cfg: CriterionConfig, draws, layer) -> Dict[str, torch.Tensor]:
    """pred_masks (B, Q, T, H, W) -> {"loss_mask", "loss_dice"} (unweighted)."""
    B, Q, T, H, W = pred_masks.shape
    N = targets.capacity
    q_idx = query_for_gt.clamp(0, Q - 1)
    src = torch.gather(pred_masks, 1, q_idx[:, :, None, None, None].expand(B, N, T, H, W))
    src = src.float().reshape(B * N * T, H, W)
    tgt = targets.masks.reshape(B * N * T, *targets.masks.shape[-2:])
    row_w = targets.valid[:, :, None].expand(B, N, T).reshape(-1).float()

    R = B * N * T
    num_sampled = int(cfg.num_points * cfg.oversample_ratio)
    num_random = cfg.num_points - int(cfg.importance_sample_ratio * cfg.num_points)
    drawn = (draws.uniform(("points", layer, "over"), (R, num_sampled, 2)).to(src.device),
             draws.uniform(("points", layer, "fill"), (R, num_random, 2)).to(src.device))
    coords = uncertain_point_coords_with_randomness(
        src.detach(), cfg.num_points, cfg.oversample_ratio, cfg.importance_sample_ratio,
        coords=drawn)
    point_logits = point_sample(src, coords)  # (R, P)
    point_labels = point_sample(tgt, coords)

    ce = point_logits.clamp(min=0) - point_logits * point_labels + F.softplus(-point_logits.abs())
    loss_mask = (ce.mean(dim=1) * row_w).sum() / num_masks
    probs = point_logits.sigmoid()
    numerator = 2.0 * (probs * point_labels).sum(dim=1)
    denominator = probs.sum(dim=1) + point_labels.sum(dim=1)
    dice = 1.0 - (numerator + 1.0) / (denominator + 1.0)
    return {"loss_mask": loss_mask, "loss_dice": (dice * row_w).sum() / num_masks}


def layer_losses(outputs: LayerOutputs, targets: VideoTargets, q4g: torch.Tensor,
                 num_masks: torch.Tensor, cfg: CriterionConfig, draws, layer,
                 suffix: str = "") -> Dict[str, torch.Tensor]:
    """The three weighted losses of one layer, keyed with ``suffix``."""
    ml = loss_masks(outputs.pred_masks, targets, q4g, num_masks, cfg, draws, layer)
    return {f"loss_ce{suffix}": cfg.class_weight * loss_labels(outputs.pred_logits, targets, q4g, cfg),
            f"loss_mask{suffix}": cfg.mask_weight * ml["loss_mask"],
            f"loss_dice{suffix}": cfg.dice_weight * ml["loss_dice"]}


def video_criterion(outputs: LayerOutputs, aux_outputs: Sequence[LayerOutputs],
                    targets: VideoTargets, cfg: CriterionConfig, draws,
                    matcher_outputs: Optional[LayerOutputs] = None,
                    num_masks: Optional[torch.Tensor] = None):
    """(losses, query_for_gt of the final layer): ``loss_ce`` /
    ``loss_mask`` / ``loss_dice``, with ``_{i}`` for auxiliary layer i."""
    if num_masks is None:
        num_masks = global_sum(targets.num_instances().sum().float()).clamp(min=1.0)
    match_from = matcher_outputs if matcher_outputs is not None else outputs
    q4g = match(match_from, targets, cfg, match_coords(draws, "final", match_from, cfg))
    losses = layer_losses(outputs, targets, q4g, num_masks, cfg, draws, "final")
    for i, aux in enumerate(aux_outputs):
        q4g_i = q4g
        if matcher_outputs is None:
            q4g_i = match(aux, targets, cfg, match_coords(draws, i, aux, cfg))
        losses.update(layer_losses(aux, targets, q4g_i, num_masks, cfg, draws, i, f"_{i}"))
    return losses, q4g
