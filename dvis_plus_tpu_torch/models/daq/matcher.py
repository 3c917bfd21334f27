"""DVIS-DAQ's per-frame matchers over padded targets.

Counterpart: ``dvis_plus_tpu/models/daq/matcher.py`` (``_frame_cost`` :33,
``frame_match`` :53, ``new_ins_match`` :83), the reference ``FrameMatcher``
and ``NewInsHungarianMatcher``:

- :func:`frame_match`: a Hungarian assignment of the frame's valid ground
  truths to the queries over the class, point-sampled sigmoid-CE and dice
  costs; besides it every query's cheapest ground truth (``aux``, a matched
  query keeping its own) and the query's validity (matched, or its best
  class probability above ``select_thr``);
- :func:`new_ins_match`: the track queries keep the ground truth their slot
  holds; ground truths that are valid now and held by no slot are matched
  among the last ``num_new_ins`` queries only, and kept where the cost is
  finite.

An assignment is dense: ``tgt_for_query[s]`` is the ground truth of query s,
-1 for none. The costs are formed on the tensors' device and solved on the
host by ``losses.matcher.solve_lap`` (``criterion.matcher_solver``). The
point set is an argument: the caller draws it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dvis_plus_tpu_torch.losses.matcher import MatchCosts, _pair_cost, solve_lap
from dvis_plus_tpu_torch.ops.point_sample import point_sample

_PAD = 1e6


def frame_cost(logits: torch.Tensor, masks: torch.Tensor, labels: torch.Tensor,
               tgt_masks: torch.Tensor, coords: torch.Tensor, costs: MatchCosts) -> torch.Tensor:
    """logits (S, K+1), masks (S, H, W), labels (N,), tgt_masks (N, Ht, Wt),
    coords (P, 2) -> (S, N) fp32."""
    src = point_sample(masks.detach().float(), coords[None]).float()
    tgt = point_sample(tgt_masks, coords[None]).float()
    return _pair_cost(logits.detach(), src, labels, tgt, costs)


class FrameMatchResult(NamedTuple):
    tgt_for_query: torch.Tensor  # (S,) matched ground truth, -1 for none
    aux_tgt_for_query: torch.Tensor  # (S,) every query's cheapest ground truth
    query_valid: torch.Tensor  # (S,) bool


@torch.no_grad()
def frame_match(logits: torch.Tensor, masks: torch.Tensor, labels: torch.Tensor,
                tgt_masks: torch.Tensor, valid_inst: torch.Tensor, coords: torch.Tensor,
                select_thr: float, costs: MatchCosts = MatchCosts()) -> FrameMatchResult:
    """One frame's matching: ``valid_inst`` (N,) the ground truths present in
    the frame. Every tensor of the result lies on the logits' device."""
    S, N = logits.shape[0], labels.shape[0]
    dev = logits.device
    C = frame_cost(logits, masks, labels, tgt_masks, coords, costs)
    C = torch.where(valid_inst[None, :], C, torch.full_like(C, _PAD))
    q4g = solve_lap(C.T.cpu(), costs.solver).to(dev)  # (N,) query a ground truth
    tgt_for_query = torch.full((S + 1,), -1, dtype=torch.long, device=dev)
    rows = torch.where(valid_inst, q4g, torch.full_like(q4g, S))
    tgt_for_query[rows] = torch.arange(N, device=dev)
    tgt_for_query = tgt_for_query[:S]
    aux = torch.where(tgt_for_query >= 0, tgt_for_query, torch.argmin(C, dim=1))
    score = logits.float().softmax(-1)[:, :-1].max(dim=1).values
    return FrameMatchResult(tgt_for_query, aux, (tgt_for_query >= 0) | (score > select_thr))


@torch.no_grad()
def new_ins_match(logits: torch.Tensor, masks: torch.Tensor, labels: torch.Tensor,
                  tgt_masks: torch.Tensor, valid_inst: torch.Tensor, tgt_for_track: torch.Tensor,
                  num_new_ins: int, coords: torch.Tensor,
                  costs: MatchCosts = MatchCosts()) -> torch.Tensor:
    """tgt_for_query (S,): ``tgt_for_track`` (S,), the ground truth each
    track slot holds (-1 for none and for the new-instance rows), with the
    new ground truths matched among the last ``num_new_ins`` queries."""
    S, N = logits.shape[0], labels.shape[0]
    dev = logits.device
    tracked = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    tracked[torch.where(tgt_for_track >= 0, tgt_for_track, torch.full_like(tgt_for_track, N))] = True
    new_inst = valid_inst & ~tracked[:N]
    C = frame_cost(logits, masks, labels, tgt_masks, coords, costs)
    C = torch.where(new_inst[None, :], C, torch.full_like(C, _PAD))
    is_new_row = torch.arange(S, device=dev) >= S - num_new_ins
    C = torch.where(is_new_row[:, None], C, torch.full_like(C, _PAD))
    q4g = solve_lap(C.T.cpu(), costs.solver).to(dev)
    accept = new_inst & (C.T[torch.arange(N, device=dev), q4g] < _PAD / 2)
    out = torch.cat([tgt_for_track, tgt_for_track.new_full((1,), -1)])
    out[torch.where(accept, q4g, torch.full_like(q4g, S))] = torch.arange(N, device=dev)
    return out[:S]
