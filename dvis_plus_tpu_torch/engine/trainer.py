"""The training step of DVIS++ online.

Counterpart: ``dvis_plus_tpu/engine/trainer.py`` (``TrainState`` :37,
``Batch`` :44, ``criterion_config`` :49, ``build_loss_fn`` :81 with its
``dvis_online`` branch :215-233, ``build_train_step`` :320), the reference
``DefaultTrainer`` step:

- the loss: the frozen segmenter without gradients, the tracker with its
  noise, then ``dvis_online_train_loss``, the matcher guided by the
  segmenter for the first ``solver.max_iter // 2`` steps; the total is the
  sum of the losses in the order of their sorted keys, as
  ``sum(jax.tree.leaves(losses))``;
- one step: backward, the optimizer's clip and update (:mod:`engine.optimizer`);
- the draws of step s come from a generator seeded by (``seed``, s)
  (:func:`utils.draws.step_generator`, the counterpart of
  ``jax.random.fold_in(key, step)`` :326), so a resumed run draws what an
  unbroken one does;
- the compute dtype is ``model.compute_dtype`` (bf16 in the YAMLs), the
  modules casting their fp32 parameters at the call, as the JAX modules
  compute; parameters and the optimizer's moments stay fp32.

The other families' losses (MinVIS, CTVIS, the offline refiner, DVIS-DAQ,
Mask2Former, open vocabulary) are ROADMAP A14c: :func:`build_loss_fn`
raises for them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from dvis_plus_tpu_torch.engine.optimizer import AdamW, build_optimizer
from dvis_plus_tpu_torch.losses.criterion import CriterionConfig
from dvis_plus_tpu_torch.losses.targets import VideoTargets
from dvis_plus_tpu_torch.utils.draws import Draws, step_generator


class Batch(NamedTuple):
    images: torch.Tensor  # (B, T, 3, H, W) normalized
    targets: VideoTargets


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: AdamW


def criterion_config(cfg) -> CriterionConfig:
    c = cfg.model.criterion
    return CriterionConfig(
        num_classes=cfg.model.num_classes, eos_coef=c.no_object_weight, class_weight=c.class_weight,
        mask_weight=c.mask_weight, dice_weight=c.dice_weight, num_points=c.train_num_points,
        oversample_ratio=c.oversample_ratio, importance_sample_ratio=c.importance_sample_ratio,
        matcher_solver=c.matcher_solver)


def build_loss_fn(cfg, model) -> Callable:
    """loss_fn(batch, draws, step) -> (total, losses)."""
    arch = cfg.model.meta_architecture
    if arch != "dvis_online":
        raise NotImplementedError(f"training {arch!r} is not ported (ROADMAP A14c)")
    from dvis_plus_tpu_torch.models.meta.dvis_online import dvis_online_train_loss

    ccfg = criterion_config(cfg)
    half_iter = cfg.solver.max_iter // 2

    def loss_fn(batch: Batch, draws, step: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        seg_out, track_out = model.train_forward(batch.images, draws)
        losses = dvis_online_train_loss(seg_out, track_out, batch.targets, ccfg,
                                        use_matcher_guidance=step < half_iter, draws=draws)
        total = sum(losses[k] for k in sorted(losses))
        return total, losses

    return loss_fn


def build_train_step(cfg, model):
    """(train_step, init_state). ``train_step(state, batch, draws=None)``
    advances ``state`` by one step in place and returns (state, metrics:
    the losses and ``total_loss`` as 0-dim tensors, and ``grad_norm``);
    ``draws`` replaces the step's own (the parity tests pass the JAX
    draws)."""
    optimizer = build_optimizer(cfg, model)
    loss_fn = build_loss_fn(cfg, model)
    device = next(model.parameters()).device

    def train_step(state: TrainState, batch: Batch, draws=None):
        if draws is None:
            draws = Draws(step_generator(cfg.seed, state.step, device))
        total, losses = loss_fn(batch, draws, state.step)
        state.optimizer.zero_grad()
        total.backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return state, metrics

    def init_state() -> TrainState:
        return TrainState(step=0, model=model, optimizer=optimizer)

    return train_step, init_state


def to_batch(raw: dict, device) -> Batch:
    """A collated loader batch (numpy, NHWC images) -> :class:`Batch` on
    ``device``."""
    images = torch.from_numpy(raw["images"]).permute(0, 1, 4, 2, 3)
    pin = device.type == "cuda"

    def put(x):
        x = torch.as_tensor(x)
        return (x.pin_memory() if pin else x).to(device, non_blocking=True)

    return Batch(images=put(images.contiguous()),
                 targets=VideoTargets(put(raw["labels"]).long(), put(raw["masks"]),
                                      put(raw["valid"]), put(raw["frame_valid"])))
