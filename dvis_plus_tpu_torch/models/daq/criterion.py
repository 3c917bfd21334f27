"""DVIS-DAQ's criterion: per-frame losses with disappearance.

Counterpart: ``dvis_plus_tpu/models/daq/criterion.py`` (``_frame_labels_loss``
:29, ``_frame_masks_loss`` :42, ``daq_criterion`` :72), the reference
``DAQCriterion``. Each frame's query set is supervised with its own
assignment (``tgt_for_query``):

- classes: a matched query takes its ground truth's class where the pair
  supervises (the ground truth present in the frame and not listed as
  disappeared), else no-object, weighted ``eos_coef``; dead slots count for
  nothing; the cross-entropy of a layer is divided by the sum of its
  weights over the frames;
- masks: point-sampled sigmoid-CE and dice over the supervising pairs,
  divided by ``num_masks``: by default the clip's :func:`matched_count`
  (at least 1); the training step passes the batch's mean count, as the
  reference all-reduces it over its one-clip GPUs;
- every layer is supervised; the last one's keys have no suffix, layer l's
  ``_{l}``.

The points of frame i's layer l come from ``draws`` under the site
``("points", i, l, "over" | "fill")``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from dvis_plus_tpu_torch.losses.criterion import CriterionConfig
from dvis_plus_tpu_torch.losses.targets import VideoTargets
from dvis_plus_tpu_torch.ops.point_sample import point_sample, uncertain_point_coords_with_randomness


def _frame_labels_loss(logits, tgt_for_query, labels, pair_ok, alive, cfg: CriterionConfig):
    """logits (S, K+1) -> (weighted NLL sum, weight sum)."""
    K = cfg.num_classes
    cls = torch.where(pair_ok, labels[tgt_for_query.clamp(0, labels.shape[0] - 1)], K)
    nll = -torch.gather(F.log_softmax(logits.float(), dim=-1), -1, cls[:, None])[:, 0]
    w = torch.where(cls == K, cfg.eos_coef, 1.0) * alive.float()
    return (nll * w).sum(), w.sum()


def _frame_masks_loss(masks, tgt_for_query, tgt_masks, pair_ok, cfg: CriterionConfig, coords):
    """masks (S, H, W) logits, tgt_masks (N, Ht, Wt) -> (CE sum, dice sum)
    over the supervising pairs."""
    src = masks.float()
    tgt = tgt_masks[tgt_for_query.clamp(0, tgt_masks.shape[0] - 1)]
    pts = uncertain_point_coords_with_randomness(
        src.detach(), cfg.num_points, cfg.oversample_ratio, cfg.importance_sample_ratio,
        coords=coords)
    pl = point_sample(src, pts)
    plab = point_sample(tgt, pts)
    w = pair_ok.float()
    ce = pl.clamp(min=0) - pl * plab + F.softplus(-pl.abs())
    probs = pl.sigmoid()
    dice = 1.0 - (2.0 * (probs * plab).sum(dim=1) + 1.0) / (probs.sum(dim=1) + plab.sum(dim=1) + 1.0)
    return (ce.mean(dim=1) * w).sum(), (dice * w).sum()


def matched_count(outputs: List[Dict]) -> torch.Tensor:
    """The matched live queries of every frame of one clip's outputs."""
    return sum(((o["tgt_for_query"] >= 0) & o["query_alive"]).sum() for o in outputs)


def daq_criterion(outputs: List[Dict], targets: VideoTargets, frame_indices: Sequence[int],
                  cfg: CriterionConfig, draws,
                  num_masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """outputs: the cutter's per-frame dicts (``pred_logits`` (L, S, K+1),
    ``pred_masks`` (L, S, H, W), ``tgt_for_query`` (S,), ``query_alive``
    (S,), ``disappeared`` (N,)); targets of one clip (labels (N,), masks
    (N, T, H, W), frame_valid (N, T)); ``frame_indices``: the target frame
    of each output."""
    N = targets.labels.shape[0]
    if num_masks is None:
        num_masks = matched_count(outputs).float().clamp(min=1.0)
    L = outputs[0]["pred_logits"].shape[0]
    n_over = int(cfg.num_points * cfg.oversample_ratio)
    n_fill = cfg.num_points - int(cfg.importance_sample_ratio * cfg.num_points)
    losses: Dict[str, torch.Tensor] = {}
    for layer in range(L):
        ce_sum = ce_w = m_sum = d_sum = 0.0
        for i, (out, fi) in enumerate(zip(outputs, frame_indices)):
            t4q, alive = out["tgt_for_query"], out["query_alive"]
            tclip = t4q.clamp(0, N - 1)
            pair_ok = (t4q >= 0) & alive & targets.frame_valid[:, fi][tclip] & ~out["disappeared"][tclip]
            c, w = _frame_labels_loss(out["pred_logits"][layer], t4q, targets.labels, pair_ok, alive, cfg)
            S = t4q.shape[0]
            dev = out["pred_masks"].device
            coords = (draws.uniform(("points", i, layer, "over"), (S, n_over, 2)).to(dev),
                      draws.uniform(("points", i, layer, "fill"), (S, n_fill, 2)).to(dev))
            m, d = _frame_masks_loss(out["pred_masks"][layer], t4q, targets.masks[:, fi], pair_ok, cfg,
                                     coords)
            ce_sum, ce_w, m_sum, d_sum = ce_sum + c, ce_w + w, m_sum + m, d_sum + d
        suffix = "" if layer == L - 1 else f"_{layer}"
        losses[f"loss_ce{suffix}"] = cfg.class_weight * ce_sum / ce_w.clamp(min=1.0)
        losses[f"loss_mask{suffix}"] = cfg.mask_weight * m_sum / num_masks
        losses[f"loss_dice{suffix}"] = cfg.dice_weight * d_sum / num_masks
    return losses
