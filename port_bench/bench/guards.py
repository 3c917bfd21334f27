"""What every run checks of its process and its machine."""
from __future__ import annotations

import subprocess
import sys
from typing import Dict, List

# compared with each loaded module's top-level name, whole: the benchmarked
# package's name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "dvis_plus_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default ``sys.modules``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


class NoDevice(SystemExit):
    pass


def require_cuda(count: int) -> None:
    """Raise ``NoDevice`` (the process exits with code 1, naming the cause)
    without ``count`` CUDA cards: a run never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("port_bench: no CUDA device is available; the benchmark runs only on the card")
    if torch.cuda.device_count() < count:
        raise NoDevice(f"port_bench: the cell needs {count} CUDA devices, "
                       f"{torch.cuda.device_count()} are visible")


def power_limit_w() -> float | None:
    """The first card's power limit in watts, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_info(count: int, memory_peak_bytes: int) -> Dict[str, object]:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(memory_peak_bytes), "power_limit_w": power_limit_w()}
