"""Vectorized auction algorithm for linear assignment.

Counterpart: ``dvis_plus_tpu/ops/assignment.py::auction_lap`` (Bertsekas'
forward auction, one stage with eps = cost_span / 5000, at most 3000 rounds,
then a fix-up pass for rows left unassigned at the round cap). Every bidding
round is dense (n, m) tensor work on the cost's device. The JAX version runs
the rounds inside a ``lax.while_loop``; in eager PyTorch each round's
convergence check reads one boolean back to the host, so a solve costs one
host sync per round plus the check that ends it (two per frame when one
bidding round suffices, as on tracker costs, whose optimum is well
separated).
"""
from __future__ import annotations

import torch

_NEG = -1e30


def auction_lap(cost: torch.Tensor, max_rounds: int = 3000) -> torch.Tensor:
    """Minimize sum of cost[i, col4row[i]] over injective assignments; n <= m.

    Returns col4row (n,) int64 on the cost's device. Ties resolve to the
    lowest column index, as ``jax.lax.top_k`` and ``jnp.argmax`` do.
    """
    n, m = cost.shape
    if n > m:
        raise ValueError(f"auction_lap needs n <= m, got {tuple(cost.shape)}")
    dev = cost.device
    if m == 1:
        return torch.zeros(n, dtype=torch.long, device=dev)
    benefit = -cost.float()
    span = torch.clamp(benefit.max() - benefit.min(), min=1e-6)
    eps = span / 5000.0

    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    col4row = torch.full((n,), -1, dtype=torch.long, device=dev)
    owner = torch.full((m,), -1, dtype=torch.long, device=dev)
    prices = torch.zeros(m, dtype=torch.float32, device=dev)

    for _ in range(max_rounds):
        unassigned = col4row < 0
        if not bool(unassigned.any()):  # one host sync per round
            break
        values = benefit - prices[None, :]
        best_j = torch.argmax(values, dim=1)  # first maximum, like lax.top_k
        best = values.gather(1, best_j[:, None])[:, 0]
        second = values.scatter(1, best_j[:, None], float("-inf")).max(dim=1).values
        bid = best - second + eps
        bid_mat = torch.where(
            unassigned[:, None] & (best_j[:, None] == cols[None, :]),
            bid[:, None],
            torch.full_like(values, _NEG),
        )
        best_bid = bid_mat.max(dim=0).values
        winner = torch.argmax(bid_mat, dim=0)  # first maximum, like jnp.argmax
        has_bid = best_bid > _NEG / 2

        prices = torch.where(has_bid, prices + best_bid, prices)
        prev_owner = torch.where(has_bid, owner, torch.full_like(owner, -1))
        outbid = ((prev_owner[None, :] == rows[:, None]) & has_bid[None, :]).any(dim=1)
        col4row = torch.where(outbid, torch.full_like(col4row, -1), col4row)
        owner = torch.where(has_bid, winner, owner)
        # each winning row takes its column; columns without a bid write to
        # a spare slot n (a scatter, not a boolean index, so no host sync)
        slots = torch.cat([col4row, col4row.new_zeros(1)])
        slots.scatter_(0, torch.where(has_bid, winner, n), torch.where(has_bid, cols, 0))
        col4row = slots[:n]
    else:  # round cap reached: place leftovers on free columns
        taken = torch.zeros(m, dtype=torch.bool, device=dev)
        taken[col4row[col4row >= 0]] = True
        for i in range(n):
            if col4row[i] < 0:
                free = int(torch.argmax((~taken).int()))
                col4row[i] = free
                taken[free] = True
    return col4row
