"""Hungarian matchers over static-shape padded targets.

Counterpart: ``dvis_plus_tpu/losses/matcher.py`` (``MatchCosts`` :34,
``solve_lap`` :48, the costs :74-109, ``video_hungarian_match`` :116,
``consistent_match`` :146), the reference's ``VideoHungarianMatcher`` and
``VideoHungarianMatcher_Consistent``:

- :func:`video_hungarian_match`: one assignment a clip over the class,
  point-sampled sigmoid-CE and dice costs, one shared point set a clip;
- :func:`consistent_match`: each ground truth is matched in the frame it
  first appears, a query matched once is pinned (cost 2 x ``_PAD_COST`` in
  later frames), and a match is kept only below ``_PAD_COST``.

The costs of every clip (and frame) are formed on the tensors' device in
one batch and copied to the host once a call; the assignments are solved
there, ``jv`` exactly (scipy, :mod:`ops.hungarian`) or ``auction``
(:mod:`ops.assignment`). The JAX package solves in the graph. The point sets
are arguments: the criterion draws them.

An assignment is dense: ``query_for_gt[b, n]`` is the query matched to
ground-truth slot n (meaningless where ``targets.valid`` is False, and -1
where :func:`consistent_match` matched nothing).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dvis_plus_tpu_torch.losses.targets import VideoTargets
from dvis_plus_tpu_torch.ops.point_sample import point_sample

_PAD_COST = 1e6


class MatchCosts(NamedTuple):
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    num_points: int = 12544
    solver: str = "jv"  # jv (exact) | auction (exact on non-degenerate costs)


def solve_lap(C_T: torch.Tensor, solver: str = "jv") -> torch.Tensor:
    """(N, Q) cost (rows the ground-truth slots) -> (N,) int64 query a row,
    minimizing the sum. For ``auction`` the two sentinel tiers (``_PAD_COST``
    for the rows of invalid slots, 2 x ``_PAD_COST`` for pinned queries) are
    first clipped to two levels just above the valid costs' span, so that
    the auction's bid step, which scales with the span, keeps the valid
    costs apart."""
    c = C_T.float()
    if solver == "jv":
        from dvis_plus_tpu_torch.ops.hungarian import hungarian

        return hungarian(c)[0]
    if solver != "auction":
        raise ValueError(f"matcher_solver must be jv or auction, got {solver}")
    from dvis_plus_tpu_torch.ops.assignment import auction_lap

    finite = c < _PAD_COST / 2
    tier2 = c >= 1.5 * _PAD_COST
    vals = c[finite]
    vmax = vals.max() if vals.numel() else c.new_tensor(1.0)
    vmin = vals.min() if vals.numel() else c.new_tensor(0.0)
    span = (vmax - vmin) + 1.0
    pad = vmax + span
    return auction_lap(torch.where(finite, c, torch.where(tier2, pad + span, pad)))


def batch_sigmoid_ce_cost(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """(..., Q, P) logits x (..., N, P) binary -> (..., Q, N) mean BCE."""
    pos = torch.nn.functional.softplus(-src)
    neg = torch.nn.functional.softplus(src)
    return (pos @ tgt.transpose(-1, -2) + neg @ (1.0 - tgt).transpose(-1, -2)) / src.shape[-1]


def batch_dice_cost(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """(..., Q, P) logits x (..., N, P) binary -> (..., Q, N) dice cost."""
    probs = src.sigmoid()
    numerator = 2.0 * (probs @ tgt.transpose(-1, -2))
    denominator = probs.sum(-1)[..., :, None] + tgt.sum(-1)[..., None, :]
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


def _pair_cost(logits, src_pts, labels, tgt_pts, costs: MatchCosts) -> torch.Tensor:
    """logits (..., Q, K+1), src_pts (..., Q, P), labels (..., N), tgt_pts
    (..., N, P) -> (..., Q, N) fp32."""
    prob = logits.float().softmax(-1)
    idx = labels[..., None, :].expand(*prob.shape[:-1], labels.shape[-1])
    cost_class = -torch.gather(prob, -1, idx.long())
    return (costs.mask_weight * batch_sigmoid_ce_cost(src_pts, tgt_pts)
            + costs.class_weight * cost_class
            + costs.dice_weight * batch_dice_cost(src_pts, tgt_pts))


@torch.no_grad()
def video_hungarian_match(
    pred_logits: torch.Tensor,  # (B, Q, K+1)
    pred_masks: torch.Tensor,  # (B, Q, T, H, W)
    targets: VideoTargets,
    coords: torch.Tensor,  # (B, P, 2): one point set a clip, shared by its frames
    costs: MatchCosts = MatchCosts(),
) -> torch.Tensor:
    """Clip-level matching. Returns query_for_gt (B, N) int64 on the host."""
    B, Q = pred_logits.shape[:2]
    N = targets.capacity
    if Q < N:
        raise ValueError(f"need num_queries >= GT capacity, got Q={Q}, N={N}")
    src = point_sample(pred_masks.float().flatten(1, 2), coords[:, None])  # (B, Q*T, P)
    tgt = point_sample(targets.masks.flatten(1, 2), coords[:, None])  # (B, N*T, P)
    src, tgt = src.reshape(B, Q, -1), tgt.reshape(B, N, -1)  # (B, Q, T*P), (B, N, T*P)
    C = _pair_cost(pred_logits, src, targets.labels, tgt, costs)
    C = torch.where(targets.valid[:, None, :], C, torch.full_like(C, _PAD_COST)).cpu()
    return torch.stack([solve_lap(C[b].T, costs.solver) for b in range(B)])


@torch.no_grad()
def consistent_match(
    pred_logits: torch.Tensor,  # (B, T, Q, K+1) per-frame logits
    pred_masks: torch.Tensor,  # (B, T, Q, H, W) per-frame masks
    targets: VideoTargets,
    coords: torch.Tensor,  # (B, T, P, 2): one point set a frame
    costs: MatchCosts = MatchCosts(),
) -> torch.Tensor:
    """First-appearance matching with query pinning. Returns query_for_gt
    (B, N) int64 on the host, -1 where nothing was matched; one assignment
    for every frame."""
    B, T, Q = pred_logits.shape[:3]
    N = targets.capacity
    src = point_sample(pred_masks.float(), coords[:, :, None])  # (B, T, Q, P)
    tgt = point_sample(targets.masks.transpose(1, 2), coords[:, :, None])  # (B, T, N, P)
    labels = targets.labels[:, None].expand(B, T, N)
    C_all = _pair_cost(pred_logits, src, labels, tgt, costs).cpu()  # (B, T, Q, N)
    valid = targets.valid.cpu().numpy()
    frame_valid = targets.frame_valid.cpu().numpy()
    q4g = np.full((B, N), -1, np.int64)
    for b in range(B):
        seen = valid[b] & frame_valid[b].any(axis=1)
        first = np.where(seen, frame_valid[b].argmax(axis=1), T)
        used = torch.zeros(Q, dtype=torch.bool)
        for f in range(T):
            cols = torch.from_numpy((first == f) & valid[b])
            if not bool(cols.any()):
                continue  # every row at the pad cost: nothing is accepted
            C = torch.where(cols[None, :], C_all[b, f], torch.full_like(C_all[b, f], _PAD_COST))
            C = torch.where(used[:, None], torch.full_like(C, 2.0 * _PAD_COST), C)
            q4col = solve_lap(C.T, costs.solver)
            accept = cols & (C.T[torch.arange(N), q4col] < _PAD_COST)
            q4g[b, accept.numpy()] = q4col[accept].numpy()
            used[q4col[accept]] = True
    return torch.from_numpy(q4g)
