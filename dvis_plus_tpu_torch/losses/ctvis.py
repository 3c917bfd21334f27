"""CTVIS: the contrastive tracking loss of segmenter finetuning.

Counterpart: ``dvis_plus_tpu/losses/ctvis.py`` (``_sgff_scan`` :32,
``ctvis_reid_loss`` :59), the reference ``CTCLPlugin`` with its
``TrainTracklet``. Per video and ground-truth instance n, with a per-frame
matching giving its query slot q(n, t):

- the anchor at frame t is the ReID embedding of slot q(n, t);
- its negatives are the first ``num_negatives`` slots of frame t - 1 other
  than q(n, t - 1) (of the first ``num_negatives + 1``);
- its positive, for t >= 1: where the instance was seen before t, with
  probability 1/2 the similarity-guided fused embedding (SGFF) after frame
  t - 1, else the last earlier embedding; where it was not, the first later
  one. The coin is a draw a (video, frame, instance): site
  ``("ctvis", "momentum", t)``, uniform (B, N), heads where > 0.5;
- each item is ``losses.reid``'s multi-positive item (one positive), the
  items of valid frames with a positive averaged over the batch.
"""
from __future__ import annotations

from typing import Dict

import torch

from dvis_plus_tpu_torch.losses.reid import multi_pos_items, normed
from dvis_plus_tpu_torch.parallel.mesh import global_sum


def sgff_scan(embeds: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Similarity-guided fusion over frames (``_sgff_scan``), batched:
    embeds (..., T, C), valid (..., T) bool -> the fused embedding after each
    frame (..., T, C). A frame's weight beta is the clamped cosine of its
    embedding with the mean of the earlier frames' normalized ones; the
    first valid frame takes its embedding as it is; an invalid frame changes
    nothing."""
    T = embeds.shape[-2]
    fused = torch.zeros_like(embeds[..., 0, :])
    acc_sum = torch.zeros_like(fused)
    acc_cnt = torch.zeros(embeds.shape[:-2], dtype=torch.long, device=embeds.device)
    out = []
    for t in range(T):
        e, v = embeds[..., t, :], valid[..., t]
        first = acc_cnt == 0
        e_n = e / (torch.linalg.norm(e, dim=-1, keepdim=True) + 1e-8)
        mean_prior = acc_sum / acc_cnt.clamp(min=1)[..., None].to(e.dtype)
        sim = (mean_prior * e_n).sum(-1, keepdim=True)
        beta = torch.maximum(sim, torch.zeros_like(sim))  # a tie splits the gradient, as JAX's
        blended = torch.where(first[..., None], e, (1 - beta) * fused + beta * e)
        fused = torch.where(v[..., None], blended, fused)
        acc_sum = torch.where(v[..., None], acc_sum + e_n, acc_sum)
        acc_cnt = acc_cnt + v.long()
        out.append(fused)
    return torch.stack(out, dim=-2)


def _last_before(valid: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """valid (B, N, T) -> (B, N, T): the last valid frame strictly before t
    (-1 where none); with ``reverse`` the first strictly after t (T where
    none)."""
    T = valid.shape[-1]
    frames = range(T - 1, -1, -1) if reverse else range(T)
    carry = torch.full(valid.shape[:-1], T if reverse else -1, dtype=torch.long, device=valid.device)
    out = [None] * T
    for t in frames:
        out[t] = carry
        carry = torch.where(valid[..., t], torch.full_like(carry, t), carry)
    return torch.stack(out, dim=-1)


def ctvis_reid_loss(reid_embeds: torch.Tensor, query_for_gt: torch.Tensor,
                    frame_valid: torch.Tensor, draws, num_negatives: int = 99,
                    momentum_embed: bool = True) -> Dict[str, torch.Tensor]:
    """reid_embeds (B, T, Q, C) the decoder's ReID embeddings (or its
    embeddings without the branch); query_for_gt (B, T, N) the per-frame
    matched slots; frame_valid (B, N, T) -> {"loss_reid", "loss_aux_reid"}."""
    B, T, Q, C = reid_embeds.shape
    N = query_for_gt.shape[2]
    nn_ = min(num_negatives, Q - 1)
    embeds = reid_embeds.float()
    slot = query_for_gt.clamp(0, Q - 1)  # (B, T, N)
    anchors = torch.gather(embeds, 2, slot[..., None].expand(B, T, N, C))  # (B, T, N, C)
    # negatives: the first nn_ of slots 0..nn_ that are not the anchor's
    base = torch.arange(nn_ + 1, device=embeds.device)
    is_anchor = base == slot[..., None]  # (B, T, N, nn_ + 1)
    neg_slots = torch.sort(is_anchor.to(torch.uint8), dim=-1, stable=True).indices[..., :nn_]
    negs = torch.gather(embeds[:, :, None].expand(B, T, N, Q, C), 3,
                        neg_slots[..., None].expand(B, T, N, nn_, C))  # (B, T, N, nn_, C)
    fvalid = frame_valid.bool()
    fused = sgff_scan(anchors.transpose(1, 2), fvalid)  # (B, N, T, C)
    prev_idx = _last_before(fvalid)  # (B, N, T)
    next_idx = _last_before(fvalid, reverse=True)
    n_idx = torch.arange(N, device=embeds.device)
    b_idx = torch.arange(B, device=embeds.device)[:, None]
    c_sum = a_sum = w_sum = embeds.new_zeros(())
    for t in range(1, T):
        has_prev = prev_idx[..., t] >= 0  # (B, N)
        has_next = next_idx[..., t] < T
        if momentum_embed:
            use_mom = draws.uniform(("ctvis", "momentum", t), (B, N)).to(embeds.device) > 0.5
        else:
            use_mom = torch.zeros(B, N, dtype=torch.bool, device=embeds.device)
        pos_prev_raw = anchors[b_idx, prev_idx[..., t].clamp(0, T - 1), n_idx]  # (B, N, C)
        pos_from_prev = torch.where(use_mom[..., None], fused[:, :, t - 1], pos_prev_raw)
        pos_next = anchors[b_idx, next_idx[..., t].clamp(0, T - 1), n_idx]
        positive = torch.where(has_prev[..., None], pos_from_prev, pos_next)
        item_w = (fvalid[..., t] & (has_prev | has_next)).float()
        anchor, neg = anchors[:, t], negs[:, t - 1]  # (B, N, C), (B, N, nn_, C)
        a_n = normed(anchor)
        dpos = (positive * anchor).sum(-1, keepdim=True)
        cos_pos = (normed(positive) * a_n).sum(-1, keepdim=True)
        dneg = torch.einsum("bngc,bnc->bng", neg, anchor)
        cos_neg = torch.einsum("bngc,bnc->bng", normed(neg), a_n)
        c, a = multi_pos_items(dpos, cos_pos, dneg, cos_neg, torch.ones_like(dneg, dtype=torch.bool))
        c_sum = c_sum + (c * item_w).sum()
        a_sum = a_sum + (a * item_w).sum()
        w_sum = w_sum + item_w.sum()
    num = global_sum(w_sum).clamp(min=1.0)
    return {"loss_reid": c_sum / num, "loss_aux_reid": a_sum / num}
