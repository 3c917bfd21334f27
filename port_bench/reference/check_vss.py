"""The comparison that decides ``correct`` in a video semantic segmentation cell.

The program's outputs of a few videos of the window (drawn from the seed) are
held against the plain reference's over the same JPEG frames, with the same
weights drawn anew from the seed (the configuration's adapter,
``adapters/<name>.py``, gives both). Each number is a worst case over the
checked videos:

- every tensor the reference gives under a name the program's capture gives
  too, as a relative L2 error (``|program - reference| / |reference|``): for
  DVIS++ offline the tracker's output queries and class logits of every
  window (``tracker_embeds``, ``tracker_logits``), the refiner's video class
  logits (``refiner_logits``), the tracker's time-averaged logits that reach
  the class map (``aux_logits``), and the mask logits that reach it at pixels
  of the stride-4 grid drawn from the seed (``mask_samples``);
- ``map_frame_mismatch``: of the (T, H, W) class maps, the largest share of a
  frame's pixels whose class differs;
- ``map_score_gap``: the widest gap, over every pixel of the class maps, by
  which the reference's score of the program's class lies below the
  reference's best score there, as a share of the best;
- ``map_clear_mismatch``: of the video's pixels where the reference's best
  class leads its second by at least 20 % of the best, the share whose class
  in the program's map differs (``reference/video.py::semantic_map``). A
  near-tie, which any rounding may flip, is left out; a wrong resize, crop,
  argmax, frame order or class id is not.

A number is compared only where ``limits`` gives it a limit; the limits are
set from the program's readings and the control's (``PERF.md``).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable

import torch


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    if a.shape != b.shape:
        return math.inf
    return float(torch.linalg.norm((a - b).flatten()) / torch.linalg.norm(b.flatten()).clamp(min=1e-30))


def frame_mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return 1.0
    return float((a.cpu() != b.cpu()).flatten(1).double().mean(1).max())


def compare(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
            name: str = "program") -> Dict[str, float]:
    """The numbers of one video; an output the program lacks reads infinity.
    ``name``: the candidate whose map numbers the reference measured."""
    out = {}
    for k, ref in reference.items():
        if k != "class_map" and not k.startswith("map:"):
            out[k] = rel_l2(program[k], ref) if k in program else math.inf
    out["map_frame_mismatch"] = (frame_mismatch(program["class_map"], reference["class_map"])
                                 if "class_map" in program else 1.0)
    prefix = f"map:{name}:"
    out.update({k[len(prefix):]: float(v) for k, v in reference.items() if k.startswith(prefix)})
    return out


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    readings = list(readings)
    keys = sorted({k for r in readings for k in r})
    return {k: max(r.get(k, math.inf) for r in readings) for k in keys}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} of the numbers that have a limit."""
    return {k: {"value": numbers.get(k, math.inf), "limit": v} for k, v in limits.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
