"""The training step of DVIS++ online and offline, MinVIS and CTVIS,
Mask2Former and Video Mask2Former, DVIS-DAQ online and offline.

Counterpart: ``dvis_plus_tpu/engine/trainer.py`` (``TrainState`` :37,
``Batch`` :44, ``criterion_config`` :49, ``build_loss_fn`` :81 with its
``minvis`` / ``ctvis`` :153-199, ``maskformer`` / ``video_maskformer``
:201-213, ``dvis_online`` :215-233, ``dvis_offline`` :235-254,
``daq_online`` :256-273 and ``daq_offline`` :275-297 branches,
``daq_curriculum_slice`` :299, ``build_train_step`` :320 with its stage
switch and its ``init_state`` :349-360), the reference ``DefaultTrainer``
step:

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
- ``daq_online``: the frozen segmenter without gradients, then each clip
  through the cutter in stage 2, or in stage 3 from step
  ``daq.increasing_step[0]`` on (the reference's switch; the JAX step
  switches at ``daq.steps[0]``, which the curriculum reads too), and
  ``daq_train_loss``;
- ``daq_offline``: the frozen segmenter and cutter streaming each clip
  without gradients, the refiner over its best sequences, and
  ``dvis_offline_train_loss`` without the class memory;
- a DAQ step trains every clip of the batch, one pass a clip, and its
  losses are the mean of the clips' (each clip's as the JAX loss gives for
  it alone, but with the mask losses divided by the batch's mean count,
  :func:`shared_count`): what the reference's one clip a GPU under DDP
  gives. The JAX step trains the first clip of its batch and drops the
  others;
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

Open-vocabulary training is ROADMAP A14c.5: :func:`build_loss_fn` raises
for it.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from dvis_plus_tpu_torch.engine.optimizer import AdamW, build_optimizer
from dvis_plus_tpu_torch.losses.criterion import CriterionConfig
from dvis_plus_tpu_torch.losses.reid import ClassMemory
from dvis_plus_tpu_torch.losses.targets import VideoTargets
from dvis_plus_tpu_torch.utils.draws import Draws, Scoped, step_generator

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

    if arch == "daq_online":
        from dvis_plus_tpu_torch.models.daq.criterion import matched_count
        from dvis_plus_tpu_torch.models.meta.daq import clip_targets, daq_train_loss

        def loss_fn(batch: Batch, draws, step: int, memory):
            per_clip = model.train_forward(batch.images, batch.targets, draws, daq_stage(cfg, step),
                                           ccfg.costs())
            num = shared_count([matched_count(o) for o, _ in per_clip])
            slot_num = shared_count([matched_count(s) for _, s in per_clip]) if per_clip[0][1] else None
            losses = mean_losses([
                daq_train_loss(outputs, slot_outputs, clip_targets(batch.targets, b), ccfg,
                               Scoped(draws, ("clip", b)), num, slot_num)
                for b, (outputs, slot_outputs) in enumerate(per_clip)])
            return total_of(losses), losses, memory

        return loss_fn

    if arch == "daq_offline":
        from dvis_plus_tpu_torch.models.meta.dvis_offline import dvis_offline_train_loss

        def loss_fn(batch: Batch, draws, step: int, memory):
            num = shared_count(batch.targets.num_instances())
            per_clip = []
            for b, (online_out, refine_out) in enumerate(model.train_forward(batch.images)):
                one = VideoTargets(*(t[b:b + 1] for t in batch.targets))
                per_clip.append(dvis_offline_train_loss(
                    online_out, refine_out, one, ccfg, use_matcher_guidance=step < half_iter,
                    draws=Scoped(draws, ("clip", b)), memory=None, num_masks=num)[0])
            losses = mean_losses(per_clip)
            return total_of(losses), losses, memory

        return loss_fn

    raise NotImplementedError(f"training {arch!r} is not ported (ROADMAP A14c.5)")


def mean_losses(per_clip):
    """The clips' losses averaged key by key."""
    return {k: sum(c[k] for c in per_clip) / len(per_clip) for k in per_clip[0]}


def shared_count(counts) -> torch.Tensor:
    """The mask losses' divisor of every clip of a DVIS-DAQ batch: the mean
    of the clips' counts, at least 1. The reference trains a clip a GPU and
    all-reduces its criterion's count over the GPUs, divided by their
    number (``mask2former_video/modeling/criterion.py:232-234``); the mean
    of the clips' losses is then the batch's sum over its whole count, as
    the other families' one criterion call gives."""
    return torch.stack(list(counts)).float().mean().clamp(min=1.0)


def daq_stage(cfg, step: int) -> int:
    """DVIS-DAQ's training stage at ``step``: 2, then 3 from
    ``daq.increasing_step[0]`` on."""
    return 2 if step < (cfg.model.daq.increasing_step or (cfg.solver.max_iter,))[0] else 3


def curriculum_frames(cfg, step: int) -> int:
    """DVIS-DAQ's frame-count curriculum: the frames a clip keeps at
    ``step``, ``daq.using_frame_num[0]`` before ``daq.steps[0]`` and
    ``using_frame_num[-1]`` from then on (0: the whole clip). Only the
    online stage has it, as the reference's ``DVIS_DAQ_online.forward``
    (:241-279); its offline stage trains on every sampled frame, where the
    JAX CLI slices ``daq_offline`` clips too."""
    ufn = cfg.model.daq.using_frame_num
    if not ufn or cfg.model.meta_architecture != "daq_online":
        return 0
    return ufn[0] if step < (cfg.model.daq.steps or (cfg.solver.max_iter,))[0] else ufn[-1]


def daq_curriculum_slice(cfg, step: int, raw: dict, rng: random.Random) -> dict:
    """The curriculum on a collated batch (numpy): a contiguous run of
    :func:`curriculum_frames` frames of every clip, its start drawn from
    ``rng`` (one draw a step, none where the run is the whole clip).
    ``valid`` stays the whole clip's, as in the JAX function."""
    n, T = curriculum_frames(cfg, step), raw["images"].shape[1]
    if n <= 0 or n >= T:
        return raw
    start = rng.randint(0, T - n)
    out = dict(raw)
    out["images"] = raw["images"][:, start:start + n]
    out["masks"] = raw["masks"][:, :, start:start + n]
    out["frame_valid"] = raw["frame_valid"][:, :, start:start + n]
    return out


def curriculum_rng(cfg, start_step: int = 0) -> random.Random:
    """The curriculum's generator, ``random.Random(seed + 17)`` (as the JAX
    CLI's), advanced past the draws of steps ``[0, start_step)`` (every clip
    has ``input.sampling_frame_num`` frames), so that a resumed run slices
    as an unbroken one."""
    rng = random.Random(cfg.seed + 17)
    T = cfg.input.sampling_frame_num
    for step in range(start_step):
        if 0 < curriculum_frames(cfg, step) < T:
            rng.randint(0, T - curriculum_frames(cfg, step))
    return rng


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
