"""Operations of a cell's work, counted on the plain reference at the cell's shapes.

``torch.utils.flop_counter.FlopCounterMode`` counts the matrix products and
convolutions of the reference's forward, run on the ``meta`` device (shapes
only, nothing computed); the deformable sampling, which it has no formula for,
is counted by ``counts.msdeform_sampling``. The count depends on the
configuration and the shapes alone, not on what implements the step, so a
later change to the program leaves it where it was. Each adapter counts its
unit of work with ``count`` (``adapters/``); counts are cached in
``port_bench/.cache`` by configuration and shape.
"""
from __future__ import annotations

import json
import os
from typing import Dict

from torch.utils.flop_counter import FlopCounterMode

from port_bench.work import counts


class _Sampling:
    """Adds the deformable sampling's operations while it is installed."""

    def __init__(self):
        self.flops = 0.0

    def __enter__(self):
        from port_bench.reference import deform

        self._mod, self._orig = deform, deform.ms_deform_attn

        def counted(value, shapes, loc, attn):
            B, Len, M, D = value.shape
            Lq, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
            self.flops += counts.msdeform_sampling(B, Len, Lq, M, L, P, D, "float32", "float32")[0]
            return self._orig(value, shapes, loc, attn)

        deform.ms_deform_attn = counted
        return self

    def __exit__(self, *exc):
        self._mod.ms_deform_attn = self._orig


def count(fn, *args, **kwargs) -> float:
    """Operations of ``fn(*args, **kwargs)``: products, convolutions and the
    deformable sampling."""
    with _Sampling() as s, FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return float(fc.get_total_flops()) + s.flops


def cached(path: str, key: str, make) -> float:
    """``make()``, kept in the JSON table at ``path`` under ``key``."""
    table: Dict[str, float] = {}
    if os.path.exists(path):
        with open(path) as f:
            table = json.load(f)
    if key not in table:
        table[key] = make()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    return table[key]
