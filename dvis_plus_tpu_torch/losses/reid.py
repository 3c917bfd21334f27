"""ReID contrastive loss of the online tracker.

Counterpart: ``dvis_plus_tpu/losses/reid.py`` (``_items_for_pair`` :26,
``reid_loss`` :49), the reference ``get_cl_loss_ref`` and ``loss_reid``:
for every frame i >= 1 and matched instance (query slot q) the anchor is
the reference embedding (i, q); the positive is slot q of the frame before
(and, for i <= T - 2, of the frame after), and the other slots of that
frame are the negatives. Per item: contrastive = logsumexp over
(negative - positive) dots and 0; aux = mean squared |cosine - label| over
the neighbour frame's slots. The class-memory form of the offline refiner
(``ClassMemory``, ``reid_loss_with_memory``) is ROADMAP A14c.
"""
from __future__ import annotations

from typing import Dict

import torch

_NEG_INF = -1e30


def _items_for_pair(anchors: torch.Tensor, neighbor: torch.Tensor, slot: torch.Tensor,
                    weight: torch.Tensor):
    """anchors (M, C), neighbor (M, Q, C), slot (M,) the positive's slot,
    weight (M,) -> (weighted contrastive sum, weighted aux sum)."""
    Q = neighbor.shape[1]
    dots = torch.einsum("mqc,mc->mq", neighbor, anchors)
    pos = torch.gather(dots, 1, slot[:, None])
    is_pos = torch.nn.functional.one_hot(slot, Q).bool()
    diffs = torch.where(is_pos, torch.full_like(dots, _NEG_INF), dots - pos)
    x = torch.cat([diffs, diffs.new_zeros(diffs.shape[0], 1)], dim=1)
    contras = torch.logsumexp(x, dim=1)

    nb_n = neighbor / (torch.linalg.norm(neighbor, dim=-1, keepdim=True) + 1e-12)
    an_n = anchors / (torch.linalg.norm(anchors, dim=-1, keepdim=True) + 1e-12)
    cos = torch.einsum("mqc,mc->mq", nb_n, an_n)
    aux = ((cos - is_pos.float()).abs() ** 2).mean(dim=1)
    return (contras * weight).sum(), (aux * weight).sum()


def reid_loss(references: torch.Tensor, query_for_gt: torch.Tensor,
              valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """references (B, T, Q, C) the tracker's ``pred_references``;
    query_for_gt (B, N); valid (B, N) -> {"loss_reid", "loss_aux_reid"}."""
    B, T, Q, C = references.shape
    N = query_for_gt.shape[1]
    refs = references.float()
    slot = query_for_gt.clamp(0, Q - 1)  # (B, N)
    w_inst = (valid & (query_for_gt >= 0)).float()  # (B, N)

    def pair(anchor_frames, neighbor_frames):
        F_ = len(anchor_frames)
        a_idx = slot[:, None, :, None].expand(B, F_, N, C)
        anchors = torch.gather(refs[:, anchor_frames], 2, a_idx).reshape(B * F_ * N, C)
        nb = refs[:, neighbor_frames][:, :, None].expand(B, F_, N, Q, C).reshape(B * F_ * N, Q, C)
        s = slot[:, None].expand(B, F_, N).reshape(-1)
        w = w_inst[:, None].expand(B, F_, N).reshape(-1)
        c, a = _items_for_pair(anchors, nb, s, w)
        return c, a, w.sum()

    prev = list(range(1, T))
    c, a, n = pair(prev, [i - 1 for i in prev])
    if T > 2:
        nxt = list(range(1, T - 1))
        c2, a2, n2 = pair(nxt, [i + 1 for i in nxt])
        c, a, n = c + c2, a + a2, n + n2
    num = n.clamp(min=1.0)
    return {"loss_reid": c / num, "loss_aux_reid": a / num}
