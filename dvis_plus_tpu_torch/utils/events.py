"""Training metrics: a JSON-lines log and smoothed console lines.

Counterpart: ``dvis_plus_tpu/utils/events.py`` (``EventWriter`` :21,
``device_memory_stats`` :82), the reference's ``EventStorage``. The JAX
profiler hooks there have no counterpart: ``torch.profiler`` is called
where it is wanted (``chip_smoke.py --profile``).
"""
from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class EventWriter:
    """``<output_dir>/metrics.jsonl``, one line a logged step, and a console
    line with each key's mean over the last ``window`` logged steps."""

    def __init__(self, output_dir: str, window: int = 20):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._file = open(self.path, "a")
        self._hist = defaultdict(lambda: deque(maxlen=window))
        self._t_last = time.time()

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step, "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        self._file.write(json.dumps(row) + "\n")
        self._file.flush()
        for k, v in metrics.items():
            self._hist[k].append(float(v))

    def smoothed(self, key: str) -> Optional[float]:
        h = self._hist.get(key)
        return sum(h) / len(h) if h else None

    def log_console(self, step: int, keys=("total_loss",)) -> None:
        now = time.time()
        dt, self._t_last = now - self._t_last, now
        parts = [f"iter {step}"]
        for k in keys:
            s = self.smoothed(k)
            if s is not None:
                parts.append(f"{k} {s:.4f}")
        parts.append(f"({dt:.2f}s)")
        logger.info("  ".join(parts))

    def close(self) -> None:
        self._file.close()


def device_memory_stats(device=None) -> Dict[str, int]:
    """The card's memory in bytes (allocated now, the peak, the total); empty
    on the CPU."""
    import torch

    if device is None or torch.device(device).type != "cuda":
        return {}
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "bytes_limit": torch.cuda.get_device_properties(device).total_memory}
