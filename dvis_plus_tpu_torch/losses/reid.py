"""ReID contrastive loss of the online tracker.

Counterpart: ``dvis_plus_tpu/losses/reid.py`` (``_items_for_pair`` :26,
``reid_loss`` :49), the reference ``get_cl_loss_ref`` and ``loss_reid``:
for every frame i >= 1 and matched instance (query slot q) the anchor is
the reference embedding (i, q); the positive is slot q of the frame before
(and, for i <= T - 2, of the frame after), and the other slots of that
frame are the negatives. Per item: contrastive = logsumexp over
(negative - positive) dots and 0; aux = mean squared |cosine - label| over
the neighbour frame's slots.

The offline refiner's form (``ClassMemory`` :97, ``_multi_pos_item`` :113,
``reid_loss_with_memory`` :140; the reference ``get_cl_loss_with_memory``
and ``Outputs_Memory_PerClasses``): every frame of a matched instance is an
anchor, the instance's embeddings at all T frames are its positives, and it
is contrasted once with the frame's other slots and once with a ring buffer
of its class's recent embeddings (20 a class), which the step then pushes
the matched embeddings into. CTVIS (``losses/ctvis.py``) shares
:func:`multi_pos_items`.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from dvis_plus_tpu_torch.parallel.mesh import gather_batch, global_sum

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
    num = global_sum(n).clamp(min=1.0)
    return {"loss_reid": c / num, "loss_aux_reid": a / num}


class ClassMemory(NamedTuple):
    """A ring buffer of reference embeddings a class: embeds (K, M, C) fp32,
    count (K,) int64, the embeddings pushed into each class so far (its
    write pointer is ``count % M``)."""

    embeds: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def create(num_classes: int, max_len: int, dim: int, device=None) -> "ClassMemory":
        return ClassMemory(torch.zeros(num_classes, max_len, dim, device=device),
                           torch.zeros(num_classes, dtype=torch.long, device=device))


def multi_pos_items(dpos: torch.Tensor, cos_pos: torch.Tensor, dneg: torch.Tensor,
                    cos_neg: torch.Tensor, neg_valid: torch.Tensor):
    """``_multi_pos_item`` over a batch of items: the dot products and
    cosines of each anchor with its P positives (dpos, cos_pos (..., P)) and
    G negatives (dneg, cos_neg (..., G); neg_valid (..., G) bool, broadcast).
    Returns (contrastive, aux) (...): logsumexp over every (negative -
    positive) pair and 0; the mean squared |cosine - label| over the
    positives and the valid negatives."""
    diffs = dneg[..., None, :] - dpos[..., :, None]  # (..., P, G)
    diffs = torch.where(neg_valid[..., None, :], diffs, torch.full_like(diffs, _NEG_INF))
    x = torch.cat([diffs.flatten(-2), diffs.new_zeros(diffs.shape[:-2] + (1,))], dim=-1)
    contras = torch.logsumexp(x, dim=-1)
    neg_valid = neg_valid.expand(cos_neg.shape)
    sq = ((cos_pos - 1.0).abs() ** 2).sum(-1) + torch.where(
        neg_valid, cos_neg.abs() ** 2, torch.zeros_like(cos_neg)).sum(-1)
    count = (cos_pos.shape[-1] + neg_valid.sum(-1)).clamp(min=1).to(sq.dtype)
    return contras, sq / count


def normed(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)


def reid_loss_with_memory(pred_embds: torch.Tensor, query_for_gt: torch.Tensor,
                          valid: torch.Tensor, labels: torch.Tensor,
                          memory: ClassMemory) -> Tuple[Dict[str, torch.Tensor], ClassMemory]:
    """pred_embds (B, T, Q, C) the refiner's normed embeddings; query_for_gt,
    valid, labels (B, N) -> ({"loss_reid", "loss_aux_reid"}, the memory with
    this step's matched embeddings pushed, without gradient)."""
    B, T, Q, C = pred_embds.shape
    K, M = memory.embeds.shape[:2]
    refs = pred_embds.float()
    slot = query_for_gt.clamp(0, Q - 1)  # (B, N)
    inst_w = (valid & (query_for_gt >= 0)).float()  # (B, N)
    cls = labels.long().clamp(0, K - 1)
    mem_e = memory.embeds[cls]  # (B, N, M, C)
    mem_valid = torch.arange(M, device=refs.device) < memory.count[cls].clamp(max=M)[..., None]
    has_mem = mem_valid.any(-1).float()  # (B, N)

    pos = torch.gather(refs, 2, slot[:, None, :, None].expand(B, T, slot.shape[1], C))  # (B, T, N, C)
    anchors, pos = pos, pos.transpose(1, 2)  # anchors (B, Ti, N, C); positives (B, N, T, C)
    a_n, p_n = normed(anchors), normed(pos)
    dpos = torch.einsum("bntc,binc->bint", pos, anchors)
    cos_pos = torch.einsum("bntc,binc->bint", p_n, a_n)
    # the frame's other slots
    d1 = torch.einsum("biqc,binc->binq", refs, anchors)
    c1 = torch.einsum("biqc,binc->binq", normed(refs), a_n)
    not_self = (torch.arange(Q, device=refs.device) != slot[..., None])[:, None]  # (B, 1, N, Q)
    con1, aux1 = multi_pos_items(dpos, cos_pos, d1, c1, not_self)
    # the class memory
    d2 = torch.einsum("bnmc,binc->binm", mem_e, anchors)
    c2 = torch.einsum("bnmc,binc->binm", normed(mem_e), a_n)
    con2, aux2 = multi_pos_items(dpos, cos_pos, d2, c2, mem_valid[:, None])
    w1 = inst_w[:, None]  # (B, 1, N)
    w2 = (inst_w * has_mem)[:, None]
    num = global_sum(T * (inst_w.sum() + (inst_w * has_mem).sum())).clamp(min=1.0)
    losses = {"loss_reid": (con1 * w1 + con2 * w2).sum() / num,
              "loss_aux_reid": (aux1 * w1 + aux2 * w2).sum() / num}
    # every rank pushes the whole batch, in its order: the memories stay equal
    return losses, push_memory(memory, *gather_batch(refs.detach(), query_for_gt, valid, labels))


@torch.no_grad()
def push_memory(memory: ClassMemory, refs: torch.Tensor, query_for_gt: torch.Tensor,
                valid: torch.Tensor, labels: torch.Tensor) -> ClassMemory:
    """Push the T embeddings of every matched instance, video by video and
    slot by slot, into its class's ring buffer (``reid_loss_with_memory``'s
    static loop :188-200): a later write to a row wins. The write positions
    are worked out on the host (one copy of the labels, assignments and
    counts), then written in one scatter."""
    B, T, Q, C = refs.shape
    K, M = memory.embeds.shape[:2]
    lab = labels.long().clamp(0, K - 1).cpu().numpy()
    ok = (valid & (query_for_gt >= 0)).cpu().numpy()
    slot = query_for_gt.clamp(0, Q - 1).cpu().numpy()
    count = memory.count.cpu().numpy().copy()
    rows = {}  # (class, ring row) -> (b, t, slot): the last write wins
    for b in range(B):
        for n in range(query_for_gt.shape[1]):
            if not ok[b, n]:
                continue
            c = lab[b, n]
            for t in range(T):
                rows[c, (count[c] + t) % M] = (b, t, slot[b, n])
            count[c] += T
    embeds = memory.embeds.clone()
    if rows:
        dst = np.array(list(rows.keys()))
        src = np.array(list(rows.values()))
        dev = refs.device
        embeds[torch.from_numpy(dst[:, 0]).to(dev), torch.from_numpy(dst[:, 1]).to(dev)] = refs[
            torch.from_numpy(src[:, 0]).to(dev), torch.from_numpy(src[:, 1]).to(dev),
            torch.from_numpy(src[:, 2]).to(dev)]
    return ClassMemory(embeds, torch.from_numpy(count).to(memory.count.device))
