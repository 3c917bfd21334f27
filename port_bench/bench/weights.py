"""The benchmark's weights: drawn from the run's seed on the device, in one call.

One standard-normal vector covers every parameter and buffer of the model,
taken in the order of their sorted names, so that two modules with the same
key space (the program's model and the plain reference) get the same values
for the same names. Each tensor is then scaled by a rule of its kind:

- a weight of two or more dimensions: ``gain / sqrt(fan_in)`` (fan-in: the
  elements of a row, or the input channels of a transposed convolution), with
  ``gain`` from the configuration's ``init_gains`` where a name part matches;
- a norm's weight and a frozen batch norm's scale: ``1 + 0.1 n``; its bias and
  running mean: ``0.1 n``; a running variance: ``exp(0.1 n)``;
- a LayerScale gain (``gamma``): ``0.1 (1 + 0.1 n)``;
- any other vector (biases): ``0.02 n``.

The program's own initialization is never run: the module is built on the
``meta`` device and its storage allocated on the card uninitialized.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch
import torch.nn as nn

_NORMS = ("LayerNorm", "GroupNorm", "BatchNorm2d")


def _kinds(model: nn.Module) -> Dict[str, Tuple[str, str]]:
    """name -> (owning module's class name, attribute name)."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, _ in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
            out[f"{mname}.{pname}" if mname else pname] = (type(mod).__name__, pname)
    return out


def tensors(model: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    named = dict(model.named_parameters())
    named.update(dict(model.named_buffers()))
    return sorted(named.items())


def _scale(name: str, kind: Tuple[str, str], t: torch.Tensor, n: torch.Tensor,
           gains: Dict[str, float]) -> torch.Tensor:
    owner, attr = kind
    if owner.endswith(_NORMS) or owner == "FrozenBatchNorm2d":
        if attr == "weight":
            return 1.0 + 0.1 * n
        if attr == "running_var":
            return torch.exp(0.1 * n)
        return 0.1 * n
    if attr == "gamma":
        return 0.1 * (1.0 + 0.1 * n)
    if t.dim() >= 2:
        fan_in = t.shape[0] if owner.startswith("ConvTranspose") else t.numel() // t.shape[0]
        gain = 1.0
        for part, g in gains.items():
            if part in name.split("."):
                gain = g
        return n * (gain / math.sqrt(fan_in))
    return 0.02 * n


@torch.no_grad()
def fill_(model: nn.Module, seed: int, gains: Dict[str, float] | None = None) -> nn.Module:
    """Overwrite every parameter and buffer of ``model`` from ``seed``, on their device."""
    named = tensors(model)
    kinds = _kinds(model)
    dev = named[0][1].device
    total = sum(t.numel() for _, t in named)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (2**63))
    noise = torch.randn(total, generator=g, device=dev, dtype=torch.float32)
    start = 0
    for name, t in named:
        n = noise[start : start + t.numel()].view(t.shape)
        start += t.numel()
        t.copy_(_scale(name, kinds[name], t, n, gains or {}))
    return model


def build_on(make, device, seed: int, gains: Dict[str, float] | None = None) -> nn.Module:
    """``make()`` built on ``meta``, allocated on ``device`` and filled from ``seed``."""
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device=device)
    return fill_(model, seed, gains).eval()


def key_space(model: nn.Module) -> Iterable[Tuple[str, Tuple[int, ...]]]:
    return [(k, tuple(t.shape)) for k, t in tensors(model)]
