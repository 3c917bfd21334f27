"""Vectorized auction algorithm for linear assignment.

Counterpart: ``dvis_plus_tpu/ops/assignment.py::auction_lap`` (Bertsekas'
forward auction, one stage with eps = cost_span / 5000, at most 3000 rounds,
then a fix-up pass for rows left unassigned at the round cap, on the host).
Every bidding round is dense (n, m) tensor work on the cost's device, or
(B, n, m) for B independent problems solved in the same rounds (the
tracker's alignment of a batch of clips, as ``jax.vmap`` runs the JAX
loop). The JAX version runs the rounds inside a ``lax.while_loop``; in
eager PyTorch a convergence check reads one boolean back to the host. ``first_check`` sets how many rounds
run before the first check; the run between checks then doubles, up to
``_MAX_RUN`` rounds. A round on a converged auction (every row assigned)
bids nothing and changes nothing, so the extra rounds leave the result of a
check after every round; the rounds stop at ``max_rounds`` all the same.
Tracker costs, whose optimum is well separated, converge in one round (one
sync a solve at ``first_check=1``), but in training the 'wa' noise repeats
reference rows and those run to the cap; the DAQ cutter's slot costs, whose dead
rows tie, take tens of rounds and check first after 16, and hundreds to
thousands where the live rows are nearly equal too (a random model's).
"""
from __future__ import annotations

import torch

from dvis_plus_tpu_torch.utils import trace

_NEG = -1e30
_MAX_RUN = 128  # most rounds between two convergence checks


def auction_lap(cost: torch.Tensor, max_rounds: int = 3000, first_check: int = 1) -> torch.Tensor:
    """Minimize sum of cost[i, col4row[i]] over injective assignments; n <= m.

    ``cost`` is (n, m), or (B, n, m) for B independent problems solved in
    the same rounds (as ``jax.vmap`` of the JAX loop runs them): a problem
    that has converged bids nothing in later rounds, so each result is the
    one its problem gives alone. Returns col4row (n,) or (B, n) int64 on
    the cost's device. Ties resolve to the lowest column index, as
    ``jax.lax.top_k`` and ``jnp.argmax`` do. ``first_check``: rounds before
    the first convergence check (the result does not depend on it). The
    tracer's span ``assignment.auction`` times a call, and its counters add
    the calls, the bidding rounds, the convergence checks (one host
    synchronization each) and the calls that reached ``max_rounds``.
    """
    if cost.dim() == 2:
        return auction_lap(cost[None], max_rounds, first_check)[0]
    with trace.span("assignment.auction"):
        trace.count("assignment.auction_calls")
        return _auction(cost, max_rounds, first_check)


def _auction(cost: torch.Tensor, max_rounds: int, first_check: int) -> torch.Tensor:
    B, n, m = cost.shape
    if n > m:
        raise ValueError(f"auction_lap needs n <= m, got {tuple(cost.shape)}")
    dev = cost.device
    if m == 1:
        return torch.zeros(B, n, dtype=torch.long, device=dev)
    benefit = -cost.float()
    span = torch.clamp(benefit.amax(dim=(1, 2)) - benefit.amin(dim=(1, 2)), min=1e-6)
    eps = (span / 5000.0)[:, None]  # (B, 1)

    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    col4row = torch.full((B, n), -1, dtype=torch.long, device=dev)
    owner = torch.full((B, m), -1, dtype=torch.long, device=dev)
    prices = torch.zeros(B, m, dtype=torch.float32, device=dev)

    def bidding_round(col4row, owner, prices):
        unassigned = col4row < 0
        values = benefit - prices[:, None, :]
        best_j = torch.argmax(values, dim=2)  # first maximum, like lax.top_k
        best = values.gather(2, best_j[..., None])[..., 0]
        second = values.scatter(2, best_j[..., None], float("-inf")).max(dim=2).values
        bid = best - second + eps
        bid_mat = torch.where(
            unassigned[..., None] & (best_j[..., None] == cols),
            bid[..., None],
            torch.full_like(values, _NEG),
        )
        best_bid = bid_mat.max(dim=1).values  # (B, m)
        winner = torch.argmax(bid_mat, dim=1)  # first maximum, like jnp.argmax
        has_bid = best_bid > _NEG / 2

        prices = torch.where(has_bid, prices + best_bid, prices)
        prev_owner = torch.where(has_bid, owner, torch.full_like(owner, -1))
        outbid = ((prev_owner[:, None, :] == rows[None, :, None]) & has_bid[:, None, :]).any(dim=2)
        col4row = torch.where(outbid, torch.full_like(col4row, -1), col4row)
        owner = torch.where(has_bid, winner, owner)
        # each winning row takes its column; columns without a bid write to
        # a spare slot n (a scatter, not a boolean index, so no host sync)
        slots = torch.cat([col4row, col4row.new_zeros(B, 1)], dim=1)
        slots.scatter_(1, torch.where(has_bid, winner, n), torch.where(has_bid, cols, 0))
        return slots[:, :n], owner, prices

    done, run, checks = 0, max(1, first_check), 0
    while done < max_rounds:
        for _ in range(min(run, max_rounds - done)):
            col4row, owner, prices = bidding_round(col4row, owner, prices)
        done, run = done + min(run, max_rounds - done), min(2 * run, max(_MAX_RUN, first_check))
        checks += 1
        if not bool((col4row < 0).any()):  # one host sync per check
            break
    else:  # round cap reached: place leftovers on free columns, on the host
        trace.count("assignment.auction_capped")
        fixed = col4row.cpu()
        for b in range(B):
            taken = torch.zeros(m, dtype=torch.bool)
            taken[fixed[b][fixed[b] >= 0]] = True
            for i in range(n):
                if fixed[b, i] < 0:
                    free = int(torch.argmax((~taken).int()))
                    fixed[b, i] = free
                    taken[free] = True
        col4row = fixed.to(dev)
    trace.count("assignment.auction_rounds", done)
    trace.count("assignment.auction_checks", checks)
    return col4row
