"""Training data loaders: an endless shuffled loader a dataset and the
ratio-weighted mixture of several.

Counterpart: ``dvis_plus_tpu/data/build.py`` (``mapper_for_type``'s
training branches, in ``data/mapper.py``, ``_collate`` :76,
``build_train_loader`` :89, ``CombinedDataLoader`` :141,
``build_combined_train_loader`` :164), the reference's loader stack. The
records are shuffled an epoch at a time by ``random.Random(seed)``; clip k
of the stream is mapped with seed ``seed * 1_000_003 + k``; worker threads
map ahead, and the batches keep the stream's order whatever the number of
workers (the JAX loader's threads hand clips over as they finish). A loader
can start ``start`` clips into its stream without mapping them, which is how
a resumed run takes up the batches where it stopped.
"""
from __future__ import annotations

import collections
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from dvis_plus_tpu_torch.data.catalog import get_dataset
from dvis_plus_tpu_torch.data.mapper import mapper_for_type


def _collate(samples: List[dict]) -> dict:
    """Stack the clips' arrays (one static shape) into batch arrays."""
    out = {key: np.stack([s[key] for s in samples])
           for key in ("images", "labels", "masks", "valid", "frame_valid") if key in samples[0]}
    out["meta"] = [{k: s[k] for k in ("image_size", "height", "width", "video_id")} for s in samples]
    return out


def _stream(records: Sequence, seed: int):
    """(record, clip seed) in the JAX loader's order, endless."""
    rng = random.Random(seed)
    counter = 0
    while True:
        order = list(range(len(records)))
        rng.shuffle(order)
        for i in order:
            counter += 1
            yield records[i], seed * 1_000_003 + counter


def build_train_loader(cfg, dataset_name: str, mapper: Optional[Callable] = None,
                       batch_size: Optional[int] = None, seed: int = 0, num_workers: int = 4,
                       start: int = 0) -> Iterator[dict]:
    """Endless batches of ``batch_size`` (``solver.ims_per_batch``) clips of
    one dataset, mapped by ``num_workers`` threads (0: on the caller's)."""
    records = get_dataset(dataset_name)
    mapper = mapper or mapper_for_type(cfg, "video_instance", is_train=True)
    batch_size = batch_size or cfg.solver.ims_per_batch
    src = _stream(records, seed)
    for _ in range(start):
        next(src)

    def batches():
        if num_workers <= 0:
            while True:
                yield _collate([mapper(*next(src)) for _ in range(batch_size)])
        with ThreadPoolExecutor(num_workers, thread_name_prefix="train-loader") as pool:
            ahead = collections.deque(pool.submit(mapper, *next(src))
                                      for _ in range(2 * batch_size))
            while True:
                items = []
                for _ in range(batch_size):
                    items.append(ahead.popleft().result())
                    ahead.append(pool.submit(mapper, *next(src)))
                yield _collate(items)

    return batches()


class CombinedDataLoader:
    """An endless ratio-weighted mixture of loaders: each batch comes whole
    from one loader, drawn by ``random.Random(seed).choices``; the batch
    carries its loader's index under ``dataset_index``."""

    def __init__(self, loaders: Sequence[Iterator], ratios: Sequence[float], seed: int = 0):
        if len(loaders) != len(ratios):
            raise ValueError(f"{len(loaders)} loaders but {len(ratios)} ratios")
        self.loaders, self.ratios = list(loaders), list(ratios)
        self.rng = random.Random(seed)

    def __iter__(self):
        return self

    def next_index(self) -> int:
        return self.rng.choices(range(len(self.loaders)), weights=self.ratios, k=1)[0]

    def __next__(self):
        idx = self.next_index()
        batch = next(self.loaders[idx])
        batch["dataset_index"] = idx
        return batch


def build_combined_train_loader(cfg, seed: int = 0, start_batches: int = 0,
                                num_workers: int = 4) -> Iterator[dict]:
    """The loader of ``datasets.train`` (ratios ``datasets.dataset_ratio``;
    each set mapped as its ``datasets.dataset_type`` entry says, the last
    entry repeated for the sets beyond the list), ``start_batches`` batches
    into its stream."""
    names = list(cfg.datasets.train)
    types = list(cfg.datasets.dataset_type) or ["video_instance"] * len(names)
    types += [types[-1]] * (len(names) - len(types))
    mappers = [mapper_for_type(cfg, t, is_train=True, dataset_name=n) for n, t in zip(names, types)]
    bs = cfg.solver.ims_per_batch
    if len(names) == 1:
        return build_train_loader(cfg, names[0], mappers[0], seed=seed, num_workers=num_workers,
                                  start=start_batches * bs)
    ratios = list(cfg.datasets.dataset_ratio) or [1.0] * len(names)
    # replay the mixture's choices to find how far into each stream it is
    replay = CombinedDataLoader([iter(())] * len(names), ratios, seed=seed)
    taken = collections.Counter(replay.next_index() for _ in range(start_batches))
    loaders = [build_train_loader(cfg, n, mappers[i], seed=seed + i, num_workers=num_workers,
                                  start=taken[i] * bs) for i, n in enumerate(names)]
    combined = CombinedDataLoader(loaders, ratios, seed=seed)
    combined.rng = replay.rng
    return combined
