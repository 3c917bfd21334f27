"""The training step of DVIS++ online and offline, MinVIS and CTVIS,
Mask2Former and Video Mask2Former, DVIS-DAQ online and offline, and the
open-vocabulary FC-CLIP segmenter (``minvis_ov``) and OV-DVIS++ online and
offline.

Counterpart: ``dvis_plus_tpu/engine/trainer.py`` (``TrainState`` :37,
``Batch`` :44, ``criterion_config`` :49, ``build_loss_fn`` :81 with its
``minvis`` / ``ctvis`` :153-199, ``maskformer`` / ``video_maskformer``
:201-213, ``dvis_online`` :215-233, ``dvis_offline`` :235-254,
``daq_online`` :256-273 and ``daq_offline`` :275-297 branches, the
``*_ov`` ones :92-152,
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
- ``minvis_ov``: the FC-CLIP segmenter (the CLIP trunk frozen) on the
  clips' frames folded into the batch, ``minvis_train_loss``;
  ``dvis_online_ov`` and ``dvis_offline_ov``: the tracker and the refiner
  as their closed forms (the segmenter without gradients; offline without
  the class memory, the JAX ``use_cl=False``). Each scores against the
  batch's training set's text classifier with that set's void row
  (:class:`Classifier`), and the criterion's class count is the
  classifier's (``len(num_templates) - 1``). One optimizer and one train
  state serve every set: :func:`build_train_step` routes a batch to its
  set's loss by ``Batch.dataset_index`` (the JAX CLI builds a jitted step a
  set over one shared state);
- a DAQ step trains every clip of the batch, one pass a clip, and its
  losses are the mean of the clips' (each clip's as the JAX loss gives for
  it alone, but with the mask losses divided by the batch's mean count,
  :func:`shared_count`): what the reference's one clip a GPU under DDP
  gives. The JAX step trains the first clip of its batch and drops the
  others. Clip b draws from a generator of its own
  (``utils.draws.clip_draws``), as what a clip draws depends on its data;
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
  compute; parameters and the optimizer's moments stay fp32;
- under a process group the step is data-parallel and equals the
  one-process step over the whole batch, as the JAX ``build_train_step``
  over a data-sharded mesh (:func:`build_train_step`, ``parallel/mesh.py``).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from dvis_plus_tpu_torch.config import OV_ARCHS, ov_arch
from dvis_plus_tpu_torch.engine.optimizer import AdamW, build_optimizer
from dvis_plus_tpu_torch.losses.criterion import CriterionConfig
from dvis_plus_tpu_torch.losses.reid import ClassMemory
from dvis_plus_tpu_torch.losses.targets import VideoTargets
from dvis_plus_tpu_torch.parallel import mesh
from dvis_plus_tpu_torch.parallel.mesh import Block
from dvis_plus_tpu_torch.utils.draws import BlockDraws, Draws, clip_draws, step_generator

MEMORY_LEN = 20  # embeddings a class in the offline stage's class memory


class Batch(NamedTuple):
    images: torch.Tensor  # (B, T, 3, H, W) normalized
    targets: VideoTargets
    dataset_index: int = 0  # the training set the batch came from
    # under data parallelism, this rank's block of the whole batch
    # (``parallel.mesh.batch_block``); None: the batch is the whole one
    block: Optional[Block] = None


class Classifier(NamedTuple):
    """An open-vocabulary training set's text classifier: the rows (R, Cc)
    without the void rows, on the model's device, the rows a class (the
    last entry the void rows' count) and the set's void row."""

    text_classifier: torch.Tensor
    num_templates: Tuple[int, ...]
    void_index: int


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


def total_of(losses):
    return sum(losses[k] for k in sorted(losses))


def build_loss_fn(cfg, model, classifier: Optional[Classifier] = None) -> Callable:
    """loss_fn(batch, draws, step, memory) -> (total, losses, memory after
    the step). An open-vocabulary architecture takes its training set's
    ``classifier``."""
    arch = ov_arch(cfg)
    ccfg = criterion_config(cfg)
    half_iter = cfg.solver.max_iter // 2

    if arch in OV_ARCHS:
        return ov_loss_fn(arch, model, ccfg, half_iter, classifier)

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
                               clip_draws(draws, b), num, slot_num)
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
                with mesh.local_sums():  # the clip's own class weights
                    per_clip.append(dvis_offline_train_loss(
                        online_out, refine_out, one, ccfg, use_matcher_guidance=step < half_iter,
                        draws=clip_draws(draws, b), memory=None, num_masks=num)[0])
            losses = mean_losses(per_clip)
            return total_of(losses), losses, memory

        return loss_fn

    raise ValueError(f"unknown meta architecture {arch!r}")


def ov_loss_fn(arch: str, model, ccfg, half_iter: int, classifier: Classifier) -> Callable:
    """The loss of an open-vocabulary architecture against ``classifier``
    (``build_loss_fn`` :92-152 there): the criterion's classes are the
    classifier's."""
    if classifier is None:
        raise ValueError(f"{arch} trains against a text classifier: pass its Classifier")
    tc, nt, vi = classifier
    ccfg = ccfg._replace(num_classes=len(nt) - 1)
    if arch == "minvis_ov":
        from dvis_plus_tpu_torch.models.meta.minvis import minvis_train_loss

        def loss_fn(batch: Batch, draws, step: int, memory):
            out = model(batch.images.flatten(0, 1), tc, nt, vi, aux=True)
            losses = minvis_train_loss(out, batch.targets, ccfg, draws)
            return total_of(losses), losses, memory

    elif arch == "dvis_online_ov":
        from dvis_plus_tpu_torch.models.meta.dvis_online import dvis_online_train_loss

        def loss_fn(batch: Batch, draws, step: int, memory):
            seg_out, track_out = model.train_forward(batch.images, tc, nt, vi, draws)
            losses = dvis_online_train_loss(seg_out, track_out, batch.targets, ccfg,
                                            use_matcher_guidance=step < half_iter, draws=draws)
            return total_of(losses), losses, memory

    else:
        from dvis_plus_tpu_torch.models.meta.dvis_offline import dvis_offline_train_loss

        def loss_fn(batch: Batch, draws, step: int, memory):
            track_out, refine_out = model.train_forward(batch.images, tc, nt, vi)
            losses, _ = dvis_offline_train_loss(track_out, refine_out, batch.targets, ccfg,
                                                use_matcher_guidance=step < half_iter, draws=draws,
                                                memory=None)
            return total_of(losses), losses, memory

    return loss_fn


def mean_losses(per_clip):
    """The clips' losses averaged key by key over the whole batch's clips
    (under data parallelism a rank's clips add their share)."""
    n = mesh.batch_total(len(per_clip))
    return {k: sum(c[k] for c in per_clip) / n for k in per_clip[0]}


def shared_count(counts) -> torch.Tensor:
    """The mask losses' divisor of every clip of a DVIS-DAQ batch: the mean
    of the whole batch's clips' counts, at least 1. The reference trains a
    clip a GPU and all-reduces its criterion's count over the GPUs, divided
    by their number (``mask2former_video/modeling/criterion.py:232-234``),
    which is what a data-parallel step does here; the mean of the clips'
    losses is then the batch's sum over its whole count, as the other
    families' one criterion call gives."""
    counts = list(counts)
    total = mesh.global_sum(torch.stack(counts).float().sum())
    return (total / mesh.batch_total(len(counts))).clamp(min=1.0)


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
    None for the other families (the open-vocabulary offline stage among
    them)."""
    if ov_arch(cfg) != "dvis_offline":
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


def build_train_step(cfg, model, classifiers: Sequence[Classifier] = ()):
    """(train_step, init_state). ``train_step(state, batch, draws=None)``
    advances ``state`` by one step in place and returns (state, metrics:
    the losses and ``total_loss`` as 0-dim tensors, and ``grad_norm``);
    ``draws`` replaces the step's own (the parity tests pass the JAX
    draws). Builds the optimizer (which freezes what the configuration
    keeps fixed) and sets the modules' modes (:func:`set_modes`). An
    open-vocabulary model takes ``classifiers``, one a training set, and a
    batch trains against ``classifiers[batch.dataset_index]``; a closed
    model has one loss for every set of its mixture.

    Under a process group (``parallel.mesh.init_distributed``) the step is
    data-parallel and equals the one-process step over the whole batch:
    ``batch`` is this rank's block of it (``batch.block``; None: every rank
    holds the whole batch), the draws are the whole batch's with the
    block's rows kept (``utils.draws.BlockDraws``), the divisors and the
    class memory's pushes span the batch (``parallel.mesh``), the
    gradients are summed over the ranks before the optimizer's clip, and
    the metrics are the summed losses. ``draws`` is then the whole batch's
    too."""
    optimizer = build_optimizer(cfg, model)
    set_modes(model)
    loss_fns = [build_loss_fn(cfg, model, c) for c in classifiers] or [build_loss_fn(cfg, model)]
    device = next(model.parameters()).device

    def train_step(state: TrainState, batch: Batch, draws=None):
        if draws is None:
            draws = Draws(step_generator(cfg.seed, state.step, device))
        block = None
        if torch.distributed.is_initialized():
            B = batch.images.shape[0]
            block = batch.block or Block(0, B, B, mesh.world()[0] == 0)
            if block.size != block.total:
                draws = BlockDraws(draws, block.start, block.size, block.total)
        loss_fn = loss_fns[batch.dataset_index if classifiers else 0]
        with mesh.data_parallel(block):
            total, losses, memory = loss_fn(batch, draws, state.step, state.memory)
        state.optimizer.zero_grad()
        total.backward()
        if block is not None:
            mesh.reduce_gradients(list(state.optimizer.params.values()), block)
        grad_norm = state.optimizer.step()
        state.step += 1
        state.memory = memory
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        if block is not None:
            metrics = mesh.reduce_metrics(metrics, block)
        metrics["grad_norm"] = grad_norm
        return state, metrics

    def init_state() -> TrainState:
        return TrainState(step=0, model=model, optimizer=optimizer, memory=init_memory(cfg, device))

    return train_step, init_state


def to_batch(raw: dict, device) -> Batch:
    """A collated loader batch (numpy, NHWC images) -> :class:`Batch` on
    ``device``, with the batch's ``dataset_index`` (0 if it has none) and
    its ``block`` (a rank's share, ``parallel.mesh.shard_batch``)."""
    images = torch.from_numpy(raw["images"]).permute(0, 1, 4, 2, 3)
    pin = device.type == "cuda"

    def put(x):
        x = torch.as_tensor(x)
        return (x.pin_memory() if pin else x).to(device, non_blocking=True)

    return Batch(images=put(images.contiguous()),
                 targets=VideoTargets(put(raw["labels"]).long(), put(raw["masks"]),
                                      put(raw["valid"]), put(raw["frame_valid"])),
                 dataset_index=int(raw.get("dataset_index", 0)), block=raw.get("block"))
