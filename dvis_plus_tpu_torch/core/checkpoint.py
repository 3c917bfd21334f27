"""Weights and training checkpoints of the port.

Counterpart: ``dvis_plus_tpu/core/checkpoint.py`` (``save`` / ``restore``
:26-40 over orbax, ``load_weights`` :42-100, ``load_torch_state_dict``
:174-195). The port keeps no orbax: a training checkpoint is one torch file
(:func:`save`) holding the model's state dict under the reference
checkpoints' keys, the optimizer's state, the step, the random generator's
state and the offline stage's class memory (``TrainState.memory``, as the
JAX train state carries it); :func:`latest` picks the newest of a directory, as
``train_net_video.py::do_train`` does for ``--resume``.

:func:`load_weights` is the non-strict load of ``weights=`` that both CLIs
share: a key the model lacks or whose shape differs is skipped and logged by
name, and the module keeps its initialization there, as the JAX loader and
the reference's checkpointer do (a class head of another class count, for
one).
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

_WRAPPERS = ("model", "state_dict", "module")


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A reference-keyed state dict from ``.npz`` or a torch file, unwrapped
    from ``{"model": ...}``, ``{"state_dict": ...}`` or ``{"module": ...}``
    (a training checkpoint of :func:`save` unwraps to its model)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: torch.from_numpy(data[k]) for k in data.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in _WRAPPERS:
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    return sd


def load_weights(model: torch.nn.Module, path: str) -> Dict[str, list]:
    """Load ``path`` into ``model`` where names and shapes agree. Returns the
    keys skipped, by kind (``missing``: the model's keys the file lacks;
    ``unexpected``: the file's keys the model lacks; ``mismatched``: shapes
    differ), each logged by name."""
    sd = load_state_dict_file(path)
    own = model.state_dict()
    mismatched = sorted(k for k, v in sd.items() if k in own and tuple(v.shape) != tuple(own[k].shape))
    keep = {k: v for k, v in sd.items() if k not in mismatched}
    missing, unexpected = model.load_state_dict(keep, strict=False)
    skipped = {"missing": sorted(set(missing) - set(mismatched)), "unexpected": sorted(unexpected),
               "mismatched": mismatched}
    for kind, keys in skipped.items():
        if keys:
            logger.warning("load_weights(%s): %d %s keys kept out: %s", path, len(keys), kind,
                           ", ".join(keys))
    logger.info("load_weights(%s): loaded %d of the model's %d keys", path,
                len(keep) - len(unexpected), len(own))
    return skipped


def save(path: str, model: torch.nn.Module, optimizer_state: dict, step: int,
         generator_state: Optional[torch.Tensor] = None, memory=None) -> None:
    """One training checkpoint, written under a private name and renamed into
    place, so a reader never sees half a file. ``memory``: a
    ``losses.reid.ClassMemory`` or None."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"model": model.state_dict(), "optimizer": optimizer_state, "step": int(step),
                "generator": generator_state,
                "memory": None if memory is None else memory._asdict()}, tmp)
    os.replace(tmp, path)


def restore(path: str) -> dict:
    """The dict :func:`save` wrote, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def latest(ckpt_dir: str) -> Optional[str]:
    """The newest checkpoint of ``ckpt_dir`` (names sort by step), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    names = sorted(n for n in os.listdir(ckpt_dir) if n.startswith("step_") and n.endswith(".pth"))
    return os.path.join(ckpt_dir, names[-1]) if names else None
