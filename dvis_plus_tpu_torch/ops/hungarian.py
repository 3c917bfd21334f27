"""Exact linear sum assignment.

Counterpart: ``dvis_plus_tpu/ops/hungarian.py::hungarian``, an in-graph
shortest-augmenting-path (Crouse 2016) solver. That is the algorithm
``scipy.optimize.linear_sum_assignment`` implements, so the port solves on
the host with scipy: one device-to-host copy of the (n, m) cost per solve.
Used for parity runs (``tracker.matcher_solver=jv``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def hungarian(cost: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-cost assignment of a (n, m) cost with n <= m.

    Returns ``(col4row (n,), row4col (m,) with -1 for free columns)`` as
    int64 tensors on the cost's device."""
    from scipy.optimize import linear_sum_assignment

    n, m = cost.shape
    if n > m:
        raise ValueError(f"hungarian needs n <= m, got {tuple(cost.shape)}")
    rows, cols = linear_sum_assignment(cost.detach().float().cpu().numpy())
    col4row = np.empty(n, np.int64)
    col4row[rows] = cols
    row4col = np.full(m, -1, np.int64)
    row4col[cols] = rows
    return (
        torch.from_numpy(col4row).to(cost.device),
        torch.from_numpy(row4col).to(cost.device),
    )
