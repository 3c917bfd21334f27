"""Data-parallel training over a process group: the ranks, each rank's block
of the batch, and the reductions that make a step at world size N equal to
the one-process step over the whole batch.

Counterpart: ``dvis_plus_tpu/parallel/mesh.py`` (``build_mesh`` :20,
``shard_batch`` :45). The JAX package puts the batch on a ``(data, model)``
mesh and lets jit partition one global-batch step, so its loss is the whole
batch's and every divisor spans it. The reference instead runs one clip a
GPU under DDP and all-reduces only the criterion's ``num_masks``
(``DVIS_Plus/train_net_video.py:318-329``,
``mask2former_video/modeling/criterion.py:232-234``). The port follows the
JAX package: a rank holds its block of the batch and computes its share of
the global-batch loss,

- every divisor that spans the batch (the criterion's mask count and its
  weighted cross-entropy's weights, the ReID and CTVIS item counts, a
  DVIS-DAQ batch's shared count and clip count) is all-reduced
  (:func:`global_sum`, :func:`batch_total`), so the ranks' losses add up to
  the global one;
- the offline stage's class memory takes every rank's embeddings, in the
  batch's order (:func:`gather_batch`), so it stays equal on every rank;
- the gradients are summed over the ranks before the optimizer's clip
  (:func:`reduce_gradients`); a missing gradient counts as zero, as the
  optimizer counts it;
- the logged losses are the summed ones (:func:`reduce_metrics`).

Each rank of a model group (``parallel.model_parallel_size`` ranks) takes the
same block, as the mesh's replication gives: the JAX package shards no
parameter over the ``model`` axis. When the batch does not divide over the
data ranks every rank takes the whole batch (``mesh.py:45-55`` replicates).
Of the ranks that hold the same block only the first (``Block.lead``) adds
its share to a sum, so a replicated step equals the one-process step exactly.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


def init_distributed(device: str = "cuda", backend: Optional[str] = None,
                     init_method: str = "env://") -> torch.device:
    """Join the process group that torchrun describes (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``) and return this rank's device: NCCL on
    ``cuda:LOCAL_RANK``, gloo on the CPU. ``backend`` is taken only from a
    caller that asks for it (two gloo ranks sharing one card), or from the
    group already made. With NCCL a rank without a card of its own raises;
    nothing falls back. Without ``WORLD_SIZE`` no group is made and
    ``device`` is returned as it is."""
    if "WORLD_SIZE" not in os.environ:
        return torch.device(device)
    world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if torch.device(device).type == "cuda":
        backend = backend or (dist.get_backend() if dist.is_initialized() else "nccl")
        if backend == "nccl" and local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} (local rank {local_rank}) has no card of its own: "
                               f"{torch.cuda.device_count()} visible, NCCL needs one a rank")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        backend = backend or "gloo"
        dev = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return dev


def world() -> tuple:
    """(rank, world size) of the process group, (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


class Block(NamedTuple):
    """A rank's share of a batch: clips ``[start, start + size)`` of the
    ``total`` clips; ``lead``: the first of the ranks that hold this block."""

    start: int
    size: int
    total: int
    lead: bool = True


def batch_block(total: int, rank: int, world_size: int, model_parallel_size: int = 1) -> Block:
    """The contiguous block of a ``total``-clip batch that ``rank`` takes:
    ``[d·B/D, (d+1)·B/D)`` for its data rank d of D = world /
    ``model_parallel_size``; the whole batch when B does not divide by D."""
    if world_size % model_parallel_size:
        raise ValueError(f"parallel.model_parallel_size={model_parallel_size} does not divide the "
                         f"world size {world_size}")
    data = world_size // model_parallel_size
    if total % data:
        return Block(0, total, total, rank == 0)
    size = total // data
    d, j = divmod(rank, model_parallel_size)
    return Block(d * size, size, total, j == 0)


def shard_batch(batch: dict, rank: int, world_size: int, model_parallel_size: int = 1) -> dict:
    """This rank's block of a collated loader batch (numpy, its ``meta``
    list too), the block under ``"block"`` (which ``engine.trainer.to_batch``
    hands the step)."""
    blk = batch_block(len(batch["images"]), rank, world_size, model_parallel_size)
    s = slice(blk.start, blk.start + blk.size)
    out = {k: (v[s] if k in ("images", "labels", "masks", "valid", "frame_valid", "meta") else v)
           for k, v in batch.items()}
    out["block"] = blk
    return out


# ---------------------------------------------------------------------------
# the reductions of a data-parallel step
# ---------------------------------------------------------------------------

_ACTIVE: List[Optional[Block]] = [None]


@contextlib.contextmanager
def data_parallel(block: Optional[Block]) -> Iterator[None]:
    """Within the block, :func:`global_sum`, :func:`batch_total` and
    :func:`gather_batch` reduce over the process group as ``block`` says
    (None: they are the identity, the one-process step)."""
    _ACTIVE.append(block)
    try:
        yield
    finally:
        _ACTIVE.pop()


@contextlib.contextmanager
def local_sums() -> Iterator[None]:
    """Within the block the sums stay the rank's own: a loss computed a clip
    at a time (DVIS-DAQ) divides by the clip's own weights."""
    with data_parallel(None):
        yield


def _block() -> Optional[Block]:
    return _ACTIVE[-1]


def _all_reduce_lead(x: torch.Tensor, block: Block) -> torch.Tensor:
    """The sum over the ranks of ``x`` where the rank leads its block, else
    of zeros (a new tensor)."""
    y = x.detach().clone() if block.lead else torch.zeros_like(x)
    dist.all_reduce(y)
    return y


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """A divisor's sum over the whole batch: the ranks' local sums added
    (the identity outside :func:`data_parallel`). No gradient flows
    through it: every divisor is made of the targets' weights."""
    block = _block()
    if block is None or block.size == block.total:
        return x
    return _all_reduce_lead(x, block)


def batch_total(n_local: int) -> int:
    """The clips of the whole batch (``n_local`` outside :func:`data_parallel`)."""
    block = _block()
    return n_local if block is None else block.total


def gather_batch(*xs: torch.Tensor) -> Sequence[torch.Tensor]:
    """The whole batch of each of ``xs`` (batch first), the ranks' blocks in
    the batch's order, on every rank. By an all-reduce into a zeroed
    buffer, which every backend runs on CUDA tensors."""
    block = _block()
    if block is None or block.size == block.total:
        return xs
    out = []
    for x in xs:
        kind = x.dtype
        buf = torch.zeros((block.total, *x.shape[1:]), device=x.device,
                          dtype=torch.int64 if kind == torch.bool else kind)
        if block.lead:
            buf[block.start:block.start + block.size] = x.detach()
        dist.all_reduce(buf)
        out.append(buf.bool() if kind == torch.bool else buf)
    return out


def reduce_gradients(params: Sequence[torch.nn.Parameter], block: Block) -> None:
    """Sum the parameters' gradients over the ranks (a missing gradient is
    zero), one all-reduce of the flattened gradients a dtype, and set every
    parameter's ``.grad`` to its reduced gradient."""
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for group in by_dtype.values():
        flat = torch.cat([(p.grad if p.grad is not None and block.lead else torch.zeros_like(p)).reshape(-1)
                          for p in group])
        dist.all_reduce(flat)
        offset = 0
        for p in group:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p)
            offset += n


def reduce_metrics(metrics: dict, block: Block) -> dict:
    """The ranks' loss shares added key by key, in one all-reduce."""
    keys = sorted(metrics)
    summed = _all_reduce_lead(torch.stack([metrics[k].detach().float() for k in keys]), block)
    return {k: summed[i] for i, k in enumerate(keys)}
