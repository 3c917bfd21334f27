"""Data-parallel runs of the port for the tests: train steps at world size N
in N spawned gloo ranks, and the same steps in one process.

Imports torch and the port only (no jax), so that a spawned rank starts
fast: the JAX side of a comparison is computed by the pytest process, which
hands the ranks their inputs as plain Python and numpy (the configuration
as namespaces, the weights as a state dict, the JAX draws as tables answered
by site). A spawn meets at a ``file://`` rendezvous of its own (pytest-xdist
runs test files side by side, so no fixed port).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import pickle
import time
import types
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

_COUNTER = itertools.count()


class TableDraws:
    """The port's draws object answering from a table site -> numpy array
    (``tests/test_torch_common.py::JaxDraws`` without jax)."""

    def __init__(self, table):
        self.table = dict(table)

    def _get(self, site, shape):
        a = self.table[site]
        assert tuple(a.shape) == tuple(shape), (site, a.shape, shape)
        return torch.from_numpy(np.array(a))

    def uniform(self, site, shape):
        return self._get(site, shape).float()

    def permutation(self, site, batch, n):
        return self._get(site, (batch, n)).long()

    def randint(self, site, low, high, shape):
        return self._get(site, shape).long()


def namespace(obj):
    """A configuration (dataclasses, of either package) as nested
    ``SimpleNamespace`` objects: what the port reads, picklable without the
    package that made it."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return types.SimpleNamespace(**{f.name: namespace(getattr(obj, f.name))
                                        for f in dataclasses.fields(obj)})
    if isinstance(obj, types.SimpleNamespace):
        return types.SimpleNamespace(**{k: namespace(v) for k, v in vars(obj).items()})
    return obj


def run(cfg, state_dict: Dict[str, torch.Tensor], batches: Sequence[dict],
        draws: Optional[Sequence[Optional[dict]]] = None, ov: bool = False,
        classifiers: Sequence[tuple] = (), rank: int = 0, world_size: int = 1,
        model_parallel_size: int = 1) -> Dict[str, Any]:
    """Train steps of the port from ``state_dict``, one a batch of
    ``batches`` (collated numpy dicts of the whole batch; a rank takes its
    block under a process group), each with the draws table of ``draws``
    (None: the step's own). ``ov``: an open-vocabulary model, trained
    against ``classifiers`` ((rows, templates, void index) a set). Returns
    each step's metrics, each step's gradients (zero where missing) and the
    parameters after, of the trained parameters by name, and the class
    memory."""
    from dvis_plus_tpu_torch.cli import build_model
    from dvis_plus_tpu_torch.cli_ov import build_ov_model
    from dvis_plus_tpu_torch.engine.trainer import Classifier, build_train_step, to_batch
    from dvis_plus_tpu_torch.parallel.mesh import shard_batch

    model = build_ov_model(cfg) if ov else build_model(cfg.model)
    model.load_state_dict(state_dict, strict=True)
    sets = [Classifier(torch.from_numpy(np.asarray(tc, np.float32)), tuple(nt), vi)
            for tc, nt, vi in classifiers]
    train_step, init = build_train_step(cfg, model, sets)
    state = init()
    grouped = torch.distributed.is_initialized()
    out = {"metrics": [], "grads": []}
    for i, raw in enumerate(batches):
        if grouped:
            raw = shard_batch(raw, rank, world_size, model_parallel_size)
        table = None if draws is None else draws[i]
        state, m = train_step(state, to_batch(raw, torch.device("cpu")),
                              None if table is None else TableDraws(table))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        # a missing gradient is zero, as the optimizer counts it
        out["grads"].append({n: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy().copy()
                             for n, p in model.named_parameters() if p.requires_grad})
    out["params"] = {n: p.detach().numpy().copy() for n, p in model.named_parameters() if p.requires_grad}
    out["memory"] = None if state.memory is None else {k: v.numpy() for k, v in state.memory._asdict().items()}
    return out


def _entry(rank: int, world_size: int, root: str, fn_name: str, threads: int) -> None:
    os.environ.update(WORLD_SIZE=str(world_size), RANK=str(rank), LOCAL_RANK=str(rank))
    torch.set_num_threads(threads)
    from dvis_plus_tpu_torch.parallel.mesh import init_distributed

    init_distributed("cpu", init_method=f"file://{os.path.join(root, 'rendezvous')}")
    with open(os.path.join(root, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    result = globals()[fn_name](rank, world_size, spec)
    with open(os.path.join(root, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    torch.distributed.destroy_process_group()


class Spawned:
    """Ranks started by :func:`spawn`; :meth:`results` waits for them, at
    most ``timeout`` seconds (then it kills them and raises, so that a rank
    stuck at a collective fails its test instead of hanging the run)."""

    def __init__(self, context, root: str, world_size: int):
        self.context, self.root, self.world_size = context, root, world_size

    def results(self, timeout: float = 600.0) -> List[Any]:
        deadline = time.monotonic() + timeout
        while not self.context.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in self.context.processes:
                    p.kill()
                raise TimeoutError(f"the spawned ranks of {self.root} ran past {timeout} s")
        out = []
        for r in range(self.world_size):
            with open(os.path.join(self.root, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def spawn(fn_name: str, spec, tmp_path, world_size: int = 2, wait: bool = True):
    """``fn_name(rank, world_size, spec)`` of this module in ``world_size``
    spawned gloo ranks, each with the caller's thread count (so that a
    CPU reduction sums as the caller's does); returns each rank's result,
    or with ``wait=False`` at once a :class:`Spawned` (the caller works on
    while the ranks run)."""
    root = os.path.join(str(tmp_path), f"spawn{next(_COUNTER)}")
    os.makedirs(root)
    with open(os.path.join(root, "spec.pkl"), "wb") as f:
        pickle.dump(spec, f)
    context = torch.multiprocessing.start_processes(
        _entry, args=(world_size, root, fn_name, torch.get_num_threads()), nprocs=world_size,
        join=False, start_method="spawn")
    spawned = Spawned(context, root, world_size)
    return spawned.results() if wait else spawned


def several(rank: int, world_size: int, jobs: Sequence[tuple]) -> List[Any]:
    """Each (function name, spec) of ``jobs`` in turn: one spawn, several
    runs."""
    return [globals()[name](rank, world_size, spec) for name, spec in jobs]


def train_runs(rank: int, world_size: int, runs: Sequence[dict]) -> List[Dict[str, Any]]:
    """:func:`run` of each keyword set of ``runs`` on this rank."""
    return [run(**r, rank=rank, world_size=world_size) for r in runs]


def cli_train_ranks(rank: int, world_size: int, spec: dict) -> Dict[str, Any]:
    """The CLI's training runs of ``spec["argv"]`` (argument lists, in turn;
    a path between them is a checkpoint that rank 0 removes, a run broken
    before it) on the sets under ``spec["data"]``; returns the paths each
    checkpoint save of this rank wrote and each run's last step."""
    os.environ["DVIS_DATASETS"] = spec["data"]
    from dvis_plus_tpu_torch import cli
    from dvis_plus_tpu_torch.core import checkpoint as ckpt

    saves, save = [], ckpt.save

    def recording(path, *args, **kwargs):
        saves.append(path)
        return save(path, *args, **kwargs)

    ckpt.save = recording
    steps = []
    for argv in spec["argv"]:
        if isinstance(argv, str):
            if rank == 0:
                os.remove(argv)
            torch.distributed.barrier()
        else:
            steps.append(cli.main(argv)["step"])
    return {"saves": saves, "steps": steps}


def uni_rows(rank: int) -> List[dict]:
    """Rank ``rank``'s MOTS rows in :func:`eval_ranks`."""
    return [{"video_id": 10 * rank + i, "score": 0.5, "category_id": 1, "segmentations": [None]}
            for i in range(rank + 1)]


def eval_ranks(rank: int, world_size: int, spec: dict) -> Dict[str, Any]:
    """The CLI's eval of each argument list of ``spec["argv"]`` on the sets
    under ``spec["data"]``; then a ``UniYTVISEvaluator`` in ``spec["uni"]``
    given this rank's rows and BDD lists (rank 1 a key of its own), written,
    and the files there once every rank has written."""
    os.environ["DVIS_DATASETS"] = spec["data"]
    from dvis_plus_tpu_torch import cli
    from dvis_plus_tpu_torch.evaluation.evaluators import UniYTVISEvaluator

    out = {task: cli.main(argv) for task, argv in spec["argv"].items()}
    ev = UniYTVISEvaluator("bdd_seg_track_val", spec["uni"])
    ev.predictions = uni_rows(rank)
    ev.process_bdd({"frames": [{"rank": rank, "i": i} for i in range(rank + 1)]})
    if rank == 1:
        ev.process_bdd({"extra": [{"rank": 1}]})
    ev.write_results()
    torch.distributed.barrier()
    out["files"] = sorted(os.listdir(spec["uni"]))
    return out


def raw_batch(images, labels, masks, valid, frame_valid, dataset_index: int = 0) -> dict:
    """A collated loader batch of numpy arrays (images (B, T, H, W, 3))."""
    return {"images": np.asarray(images, np.float32), "labels": np.asarray(labels),
            "masks": np.asarray(masks), "valid": np.asarray(valid),
            "frame_valid": np.asarray(frame_valid), "dataset_index": dataset_index}


def norm_gap(got, want) -> float:
    """|got - want| / |want| over the concatenated arrays."""
    g = np.concatenate([np.ravel(x) for x in got]).astype(np.float64)
    w = np.concatenate([np.ravel(x) for x in want]).astype(np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))
