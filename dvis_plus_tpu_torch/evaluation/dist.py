"""The evaluators' gather over the ranks of a process group.

Counterpart: ``dvis_plus_tpu/evaluation/dist.py`` (``is_main_process`` :20,
``gather_predictions`` :24), the reference's ``comm.gather(predictions,
dst=0)`` (``DVIS_Plus/dvis_Plus/data_video/ytvis_eval.py:115-143``). Each
rank evaluates its stripe of the videos (``data.build.build_test_loader``);
the rows are joined rank by rank (rank 0's, then rank 1's), as the JAX
function concatenates them, and rank 0 writes the files and scores. Without
a process group every function is the identity.
"""
from __future__ import annotations

from typing import Any, List

import torch.distributed as dist

from dvis_plus_tpu_torch.parallel.mesh import world


def is_main_process() -> bool:
    return world()[0] == 0


def gather_predictions(local_rows: List[Any]) -> List[Any]:
    """Every rank's rows, rank by rank, on every rank (only rank 0 should
    write them)."""
    _, world_size = world()
    if world_size == 1:
        return local_rows
    parts: List[Any] = [None] * world_size
    dist.all_gather_object(parts, local_rows)
    return [row for part in parts for row in part]
