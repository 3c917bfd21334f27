"""The training step of DVIS++ online and offline, MinVIS and CTVIS,
Mask2Former and Video Mask2Former.

Counterpart: ``dvis_plus_tpu/engine/trainer.py`` (``TrainState`` :37,
``Batch`` :44, ``criterion_config`` :49, ``build_loss_fn`` :81 with its
``minvis`` / ``ctvis`` :153-199, ``maskformer`` / ``video_maskformer``
:201-213, ``dvis_online`` :215-233 and ``dvis_offline`` :235-254
branches, ``build_train_step`` :320 and its ``init_state`` :349-360), the
reference ``DefaultTrainer`` step:

- ``dvis_online``: the frozen segmenter without gradients, the tracker with
  its noise, then ``dvis_online_train_loss``, the matcher guided by the
  segmenter for the first ``solver.max_iter // 2`` steps;
- ``minvis`` / ``ctvis``: the bare segmenter on the clips' frames folded
  into the batch, trained whole (the backbone at ``backbone_multiplier``),
  ``minvis_train_loss``; CTVIS adds its contrastive tracking loss
  (``losses.ctvis``) over a per-frame matching, weighted
  ``model.criterion.reid_weight`` / ``aux_reid_weight``;
- ``dvis_offline``: the frozen online stack without gradients, the refiner,
  then ``dvis_offline_train_loss`` with the class memory, which the train
  state carries from step to step (:class:`TrainState` ``memory``);
- the total is the sum of the losses in the order of their sorted keys, as
  ``sum(jax.tree.leaves(losses))``;
- one step: backward, the optimizer's clip and update (:mod:`engine.optimizer`);
- the modules train in training mode (Swin's stochastic depth, its window
  attention through the plain op), but a module every parameter of which
  is frozen runs in eval mode (:func:`set_modes`), as it computes without
  gradients (a frozen segmenter or ViT trunk);
- the draws of step s come from a generator seeded by (``seed``, s)
  (:func:`utils.draws.step_generator`, the counterpart of
  ``jax.random.fold_in(key, step)`` :326), so a resumed run draws what an
  unbroken one does;
- the compute dtype is ``model.compute_dtype`` (bf16 in the YAMLs), the
  modules casting their fp32 parameters at the call, as the JAX modules
  compute; parameters and the optimizer's moments stay fp32.

The other families' losses (DVIS-DAQ, open vocabulary) are ROADMAP
A14c.4-A14c.5: :func:`build_loss_fn` raises for them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from dvis_plus_tpu_torch.engine.optimizer import AdamW, build_optimizer
from dvis_plus_tpu_torch.losses.criterion import CriterionConfig
from dvis_plus_tpu_torch.losses.reid import ClassMemory
from dvis_plus_tpu_torch.losses.targets import VideoTargets
from dvis_plus_tpu_torch.utils.draws import Draws, step_generator

MEMORY_LEN = 20  # embeddings a class in the offline stage's class memory


class Batch(NamedTuple):
    images: torch.Tensor  # (B, T, 3, H, W) normalized
    targets: VideoTargets


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: AdamW
    memory: Optional[ClassMemory] = None  # the offline stage's class memory


def criterion_config(cfg) -> CriterionConfig:
    c = cfg.model.criterion
    return CriterionConfig(
        num_classes=cfg.model.num_classes, eos_coef=c.no_object_weight, class_weight=c.class_weight,
        mask_weight=c.mask_weight, dice_weight=c.dice_weight, num_points=c.train_num_points,
        oversample_ratio=c.oversample_ratio, importance_sample_ratio=c.importance_sample_ratio,
        matcher_solver=c.matcher_solver)


def build_loss_fn(cfg, model) -> Callable:
    """loss_fn(batch, draws, step, memory) -> (total, losses, memory after
    the step)."""
    arch = cfg.model.meta_architecture
    ccfg = criterion_config(cfg)
    half_iter = cfg.solver.max_iter // 2

    def total_of(losses):
        return sum(losses[k] for k in sorted(losses))

    if arch in ("minvis", "ctvis"):
        from dvis_plus_tpu_torch.losses import criterion
        from dvis_plus_tpu_torch.losses.ctvis import ctvis_reid_loss
        from dvis_plus_tpu_torch.models.meta.minvis import frame_fold_targets, minvis_train_loss

        c = cfg.model.criterion

        def loss_fn(batch: Batch, draws, step: int, memory):
            B, T = batch.images.shape[:2]
            out = model(batch.images.flatten(0, 1), aux=True, draws=draws)
            losses = minvis_train_loss(out, batch.targets, ccfg, draws)
            if arch == "ctvis":
                # a clip-level matching of every frame feeds the contrastive
                # tracking loss (the reference CTMinVIS)
                ft = frame_fold_targets(batch.targets)
                frames = criterion.LayerOutputs(out["pred_logits"], out["pred_masks"][:, :, None])
                coords = draws.uniform(("ctvis", "match"), (B * T, ccfg.num_points, 2))
                q4g = criterion.match(frames, ft, ccfg, coords.to(batch.images.device))
                reid = out.get("pred_reid_embed", out["pred_embds"])
                cl = ctvis_reid_loss(reid.reshape(B, T, -1, reid.shape[-1]),
                                     q4g.reshape(B, T, -1), batch.targets.frame_valid, draws)
                losses["loss_reid"] = c.reid_weight * cl["loss_reid"]
                losses["loss_aux_reid"] = c.aux_reid_weight * cl["loss_aux_reid"]
            return total_of(losses), losses, memory

        return loss_fn

    if arch in ("maskformer", "video_maskformer"):
        from dvis_plus_tpu_torch.models.meta.video_maskformer import video_maskformer_train_loss

        def loss_fn(batch: Batch, draws, step: int, memory):
            out = model(batch.images, aux=True, draws=draws)
            losses = video_maskformer_train_loss(out, batch.targets, ccfg, draws)
            return total_of(losses), losses, memory

        return loss_fn

    if arch == "dvis_online":
        from dvis_plus_tpu_torch.models.meta.dvis_online import dvis_online_train_loss

        def loss_fn(batch: Batch, draws, step: int, memory):
            seg_out, track_out = model.train_forward(batch.images, draws)
            losses = dvis_online_train_loss(seg_out, track_out, batch.targets, ccfg,
                                            use_matcher_guidance=step < half_iter, draws=draws)
            return total_of(losses), losses, memory

        return loss_fn

    if arch == "dvis_offline":
        from dvis_plus_tpu_torch.models.meta.dvis_offline import dvis_offline_train_loss

        def loss_fn(batch: Batch, draws, step: int, memory):
            track_out, refine_out = model.train_forward(batch.images)
            losses, memory = dvis_offline_train_loss(
                track_out, refine_out, batch.targets, ccfg, use_matcher_guidance=step < half_iter,
                draws=draws, memory=memory)
            return total_of(losses), losses, memory

        return loss_fn

    raise NotImplementedError(f"training {arch!r} is not ported (ROADMAP A14c.4-A14c.5)")


def init_memory(cfg, device) -> Optional[ClassMemory]:
    """The offline stage's empty class memory (``init_state`` :351-355):
    ``MEMORY_LEN`` embeddings a class, as wide as the refiner's queries;
    None for the other families."""
    if cfg.model.meta_architecture != "dvis_offline":
        return None
    td = cfg.model.transformer_decoder
    return ClassMemory.create(cfg.model.num_classes, MEMORY_LEN,
                              td.hidden_dim * (2 if td.reid_branch else 1), device)


def set_modes(model: torch.nn.Module) -> None:
    """Training mode, but eval mode for every module whose parameters are
    all frozen (``requires_grad`` off)."""
    model.train()
    for m in model.modules():
        params = list(m.parameters())
        if params and not any(p.requires_grad for p in params):
            m.eval()


def build_train_step(cfg, model):
    """(train_step, init_state). ``train_step(state, batch, draws=None)``
    advances ``state`` by one step in place and returns (state, metrics:
    the losses and ``total_loss`` as 0-dim tensors, and ``grad_norm``);
    ``draws`` replaces the step's own (the parity tests pass the JAX
    draws). Builds the optimizer (which freezes what the configuration
    keeps fixed) and sets the modules' modes (:func:`set_modes`)."""
    optimizer = build_optimizer(cfg, model)
    set_modes(model)
    loss_fn = build_loss_fn(cfg, model)
    device = next(model.parameters()).device

    def train_step(state: TrainState, batch: Batch, draws=None):
        if draws is None:
            draws = Draws(step_generator(cfg.seed, state.step, device))
        total, losses, memory = loss_fn(batch, draws, state.step, state.memory)
        state.optimizer.zero_grad()
        total.backward()
        grad_norm = state.optimizer.step()
        state.step += 1
        state.memory = memory
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return state, metrics

    def init_state() -> TrainState:
        return TrainState(step=0, model=model, optimizer=optimizer, memory=init_memory(cfg, device))

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
