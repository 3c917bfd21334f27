"""The optimizer: AdamW with the reference's parameter groups, the
full-model gradient clip and stage freezing.

Counterpart: ``dvis_plus_tpu/engine/optimizer.py`` (``_no_weight_decay``
:35, ``make_optimizer`` :53-96, ``make_frozen_predicate`` :99,
``warmup_multistep_schedule`` :121), the reference ``build_optimizer``:

- groups ``main`` (the base learning rate), ``backbone`` (x
  ``backbone_multiplier``) and ``frozen``; a frozen parameter gets
  ``requires_grad_(False)`` and no state (the JAX package zeroes its updates);
  the components ``model.freeze`` names are frozen, and so is the DINOv2
  trunk of a ViT-Adapter with ``backbone.vit_frozen`` (the reference's frozen
  trunk; the JAX optimizer leaves it in the backbone group, no code there
  reading the field);
- no weight decay on 1-D parameters (biases, norm scales) and on the names
  holding ``norm`` or an embedding (:func:`no_weight_decay`, the JAX rule on
  the reference names the port's modules carry);
- the gradient clipped by its global norm over all parameters before the
  update, as ``optax.clip_by_global_norm``: g / ||g|| x c where ||g|| >= c
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm);
- the update in ``optax.adamw``'s order: Adam's moments with bias correction,
  the decayed weights added, then the learning rate of the group.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

_NO_DECAY = ("norm", "query_embed", "query_feat", "level_embed", "pos_embed",
             "relative_position", "absolute_pos")

# the JAX package's component names -> the port's top-level module names
_COMPONENTS = {"segmenter": ("backbone.", "sem_seg_head."), "tracker": ("tracker.",),
               "cutter": ("tracker.",),
               "backbone": ("backbone.",), "refiner": ("refiner.",)}


def no_weight_decay(name: str, param: torch.Tensor) -> bool:
    """The JAX rule on the port's names. An attention's ``in_proj_bias`` is
    1-D here but three (heads, head_dim) leaves in the JAX modules, which
    that rule decays (the reference decays every bias), so it decays."""
    if name.endswith("in_proj_bias"):
        return False
    return param.dim() <= 1 or any(k in name.lower() for k in _NO_DECAY)


def is_backbone(name: str) -> bool:
    return "backbone" in name


def make_frozen_predicate(frozen_components: Sequence[str]) -> Callable[[str], bool]:
    """``model.freeze`` names -> a predicate of a parameter's name:
    ``segmenter`` freezes the backbone and the pixel and query decoders,
    ``tracker`` the tracker, ``cutter`` DVIS-DAQ's cutter (the port's
    ``tracker``), ``backbone`` the backbone; another name freezes
    the parameters whose name holds it."""
    prefixes = [p for comp in frozen_components for p in _COMPONENTS.get(comp, ())]
    others = [c for c in frozen_components if c not in _COMPONENTS]

    def frozen(name: str) -> bool:
        return name.startswith(tuple(prefixes)) or any(c in name for c in others)

    return frozen


def group_label(name: str, frozen: Callable[[str], bool]) -> str:
    if frozen(name):
        return "frozen"
    return "backbone" if is_backbone(name) else "main"


def warmup_multistep_schedule(base_lr: float, steps: Sequence[int], gamma: float = 0.1,
                              warmup_iters: int = 10, warmup_factor: float = 0.001):
    """detectron2's WarmupMultiStepLR: step -> learning rate."""

    def schedule(count: int) -> float:
        warm = 1.0
        if count < warmup_iters:
            warm = warmup_factor + (1.0 - warmup_factor) * (count / max(warmup_iters, 1))
        decay = 1.0
        for s in steps:
            if count >= s:
                decay *= gamma
        return base_lr * warm * decay

    return schedule


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """(``grads`` scaled to a global norm of at most ``max_norm`` by optax's
    formula, the norm before the clip)."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    clipped = norm >= max_norm
    return [torch.where(clipped, (g / norm.to(g.dtype)) * max_norm, g) for g in grads], norm


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay ** count in float32 by square-and-multiply, as optax's
    ``1 - decay**count`` on an int32 count computes it in the JAX package
    (at b2 = 0.999 the float32 rounding of the power moves the correction
    by some 1e-5)."""
    x, acc, n = np.float32(decay), np.float32(1.0), count
    while n:
        if n & 1:
            acc = np.float32(acc * x)
        x, n = np.float32(x * x), n >> 1
    return float(np.float32(1.0) - acc)


class AdamW:
    """AdamW over a model's named parameters in the reference's groups.
    :meth:`step` reads each parameter's ``.grad``; the learning rate of a
    step comes from ``schedule(count)``, count the updates made before."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], schedule,
                 weight_decay: float = 0.05, backbone_multiplier: float = 0.1,
                 clip_value: float = 0.01, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, frozen: Callable[[str], bool] = lambda name: False):
        self.schedule, self.weight_decay, self.clip_value = schedule, weight_decay, clip_value
        self.betas, self.eps = betas, eps
        self.mult = {"main": 1.0, "backbone": backbone_multiplier}
        self.params: Dict[str, torch.nn.Parameter] = {}
        self.labels: Dict[str, str] = {}
        self.decay: Dict[str, bool] = {}
        for name, p in named_params:
            label = group_label(name, frozen)
            if label == "frozen":
                p.requires_grad_(False)
                continue
            self.params[name], self.labels[name] = p, label
            self.decay[name] = not no_weight_decay(name, p)
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' gradients (a missing gradient is
        zero; ``.grad`` is left as it was); returns the global gradient norm
        before the clip."""
        raw = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params.values()]
        clipped, norm = clip_by_global_norm(raw, self.clip_value)
        grads = dict(zip(self.params, clipped))
        b1, b2 = self.betas
        lr = self.schedule(self.count)
        self.count += 1
        c1, c2 = _bias_correction(b1, self.count), _bias_correction(b2, self.count)
        for n, p in self.params.items():
            g = grads[n]
            mu, nu = self.mu[n], self.nu[n]
            mu.copy_((1.0 - b1) * g + b1 * mu)
            nu.copy_((1.0 - b2) * (g * g) + b2 * nu)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.decay[n]:
                u = u + self.weight_decay * p
            p.add_(u * (-self.mult[self.labels[n]] * lr))
        return norm

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for n, p in self.params.items():
            self.mu[n].copy_(state["mu"][n])
            self.nu[n].copy_(state["nu"][n])


VIT_TRUNK = "backbone.vit_module."  # the DINOv2 trunk of a ViT-Adapter backbone


def frozen_predicate(model_cfg) -> Callable[[str], bool]:
    """What training keeps fixed: the components of ``model.freeze`` and,
    with ``backbone.vit_frozen``, the ViT-Adapter's trunk."""
    by_name = make_frozen_predicate(model_cfg.freeze)
    b = model_cfg.backbone
    trunk = b.name == "vit_adapter_dinov2" and b.vit_frozen
    return lambda name: by_name(name) or (trunk and name.startswith(VIT_TRUNK))


def build_optimizer(cfg, model: torch.nn.Module) -> AdamW:
    """The optimizer of ``cfg.solver`` over ``model``, with what
    :func:`frozen_predicate` names frozen (``engine/trainer.py::
    build_optimizer`` :66)."""
    s = cfg.solver
    return AdamW(model.named_parameters(),
                 warmup_multistep_schedule(s.base_lr, s.steps, s.gamma, s.warmup_iters,
                                           s.warmup_factor),
                 weight_decay=s.weight_decay, backbone_multiplier=s.backbone_multiplier,
                 clip_value=s.clip_gradients_value, frozen=frozen_predicate(cfg.model))
