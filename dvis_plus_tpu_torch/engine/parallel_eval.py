"""Video-parallel eval in one process: a worker thread a device.

Counterpart: ``dvis_plus_tpu/engine/parallel_eval.py`` (``RecordingEvaluator``
:36, ``eval_device_count`` :53, ``run_device_parallel`` :61). The reference
spawns a DDP process a GPU and stripes the videos over the ranks
(detectron2's ``InferenceSampler``); here one process fans the per-video
driver out over ``test.eval_devices`` cards, each worker running the
ordinary driver on its stripe ``records[i::n]`` with its own copy of the
model on its device. The workers' evaluator calls are buffered and
replayed into the real evaluator after the join, interleaved (video 0 of
worker 0, video 0 of worker 1, ..., video 1 of worker 0, ...), so that the
files are those of a sequential run, whatever the workers' timing.

Composes with the ranks of a process group (``data.build.build_test_loader``
stripes a rank's share first), but a rank of a group owns one card, so
there each rank evaluates alone.
"""
from __future__ import annotations

import contextlib
import copy
import logging
import threading
from typing import Callable, Iterator, List, Optional, Sequence

import torch

from dvis_plus_tpu_torch.parallel.mesh import world

logger = logging.getLogger(__name__)


class RecordingEvaluator:
    """Buffers evaluator calls for the ordered replay after the join."""

    def __init__(self):
        self.calls: List[tuple] = []

    def process(self, *args, **kwargs) -> None:
        self.calls.append(("process", args, kwargs))

    def process_bdd(self, *args, **kwargs) -> None:
        self.calls.append(("process_bdd", args, kwargs))


def eval_device_count(cfg, device: torch.device) -> int:
    """``test.eval_devices`` (0: every card), at most the cards present; 1
    on the CPU and on a rank of a process group."""
    n = int(getattr(cfg.test, "eval_devices", 1))
    if device.type != "cuda" or world()[1] > 1:
        return 1
    n_local = torch.cuda.device_count()
    return max(1, min(n or n_local, n_local))


def run_device_parallel(cfg, driver: Callable, make_loader: Callable[[int, int], Iterator[dict]],
                        evaluator, model: torch.nn.Module,
                        devices: Optional[Sequence[torch.device]] = None) -> None:
    """Fan ``driver(model, loader, evaluator)`` out over the devices:
    ``cuda:0 .. n-1`` for ``n = eval_device_count(cfg, model's device)``,
    or ``devices`` (a test names ``[cpu] * 4``, the chip smoke the one card
    twice). ``make_loader(i, n)`` yields the videos ``records[i::n]``. An
    exception of a worker is raised here after the join."""
    home = next(model.parameters()).device
    if devices is None:
        n = eval_device_count(cfg, home)
        devices = [torch.device("cuda", i) for i in range(n)] if n > 1 else [home]
    n = len(devices)
    if n <= 1:
        driver(model, make_loader(0, 1), evaluator)
        return
    if int(getattr(cfg.test, "refiner_shard_devices", 0)) > 1:
        raise ValueError("test.eval_devices and test.refiner_shard_devices both claim the "
                         "devices; enable one or the other")
    buffers = [RecordingEvaluator() for _ in range(n)]
    errors: List[Optional[BaseException]] = [None] * n
    replicas = [copy.deepcopy(model).to(d) for d in devices]

    def work(i: int) -> None:
        on_device = (torch.cuda.device(devices[i]) if devices[i].type == "cuda"
                     else contextlib.nullcontext())
        try:
            with on_device:
                driver(replicas[i], make_loader(i, n), buffers[i])
        except BaseException as e:  # raised after the join
            errors[i] = e

    threads = [threading.Thread(target=work, args=(i,), name=f"eval-dev{i}", daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    # worker i buffered videos i, i + n, ...: interleave them back
    calls = [b.calls[j] for j in range(max(len(b.calls) for b in buffers))
             for b in buffers if j < len(b.calls)]
    for name, args, kwargs in calls:
        getattr(evaluator, name)(*args, **kwargs)
    logger.info("device-parallel eval: %d evaluator calls over %d devices", len(calls), n)
