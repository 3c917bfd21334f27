"""Data loaders: an endless shuffled training loader a dataset and the
ratio-weighted mixture of several; the eval loader, striped over the ranks.

Counterpart: ``dvis_plus_tpu/data/build.py`` (``mapper_for_type``'s
training branches, in ``data/mapper.py``, ``_collate`` :76,
``build_train_loader`` :89, ``CombinedDataLoader`` :141,
``build_combined_train_loader`` :164, ``shard_records`` :186,
``build_test_loader`` :193), the reference's loader stack. The
records are shuffled an epoch at a time by ``random.Random(seed)``; clip k
of the stream is mapped with seed ``seed * 1_000_003 + k``; worker threads
map ahead, and the batches keep the stream's order whatever the number of
workers (the JAX loader's threads hand clips over as they finish). A loader
can start ``start`` clips into its stream without mapping them, which is how
a resumed run takes up the batches where it stopped. A data-parallel rank
maps only its block of each batch (``block``), the clips it would hold of
the whole batch.
"""
from __future__ import annotations

import collections
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

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
                       start: int = 0, block: Optional[Tuple[int, int]] = None) -> Iterator[dict]:
    """Endless batches of ``batch_size`` (``solver.ims_per_batch``) clips of
    one dataset, mapped by ``num_workers`` threads (0: on the caller's).
    ``block=(first, count)``: of every batch only clips ``[first, first +
    count)``, the same clips the whole batch holds there (a data-parallel
    rank's share; the others are passed over unmapped)."""
    records = get_dataset(dataset_name)
    mapper = mapper or mapper_for_type(cfg, "video_instance", is_train=True)
    batch_size = batch_size or cfg.solver.ims_per_batch
    src = _stream(records, seed)
    for _ in range(start):
        next(src)
    lo, n = block or (0, batch_size)

    def clips():
        while True:
            yield from [next(src) for _ in range(batch_size)][lo:lo + n]

    own = clips()

    def batches():
        if num_workers <= 0:
            while True:
                yield _collate([mapper(*next(own)) for _ in range(n)])
        with ThreadPoolExecutor(num_workers, thread_name_prefix="train-loader") as pool:
            ahead = collections.deque(pool.submit(mapper, *next(own)) for _ in range(2 * n))
            while True:
                items = []
                for _ in range(n):
                    items.append(ahead.popleft().result())
                    ahead.append(pool.submit(mapper, *next(own)))
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
                                num_workers: int = 4,
                                block: Optional[Tuple[int, int]] = None) -> Iterator[dict]:
    """The loader of ``datasets.train`` (ratios ``datasets.dataset_ratio``;
    each set mapped as its ``datasets.dataset_type`` entry says, the last
    entry repeated for the sets beyond the list), ``start_batches`` batches
    into its stream; ``block`` as :func:`build_train_loader`'s."""
    names = list(cfg.datasets.train)
    types = list(cfg.datasets.dataset_type) or ["video_instance"] * len(names)
    types += [types[-1]] * (len(names) - len(types))
    mappers = [mapper_for_type(cfg, t, is_train=True, dataset_name=n) for n, t in zip(names, types)]
    bs = cfg.solver.ims_per_batch
    if len(names) == 1:
        return build_train_loader(cfg, names[0], mappers[0], seed=seed, num_workers=num_workers,
                                  start=start_batches * bs, block=block)
    ratios = list(cfg.datasets.dataset_ratio) or [1.0] * len(names)
    # replay the mixture's choices to find how far into each stream it is
    replay = CombinedDataLoader([iter(())] * len(names), ratios, seed=seed)
    taken = collections.Counter(replay.next_index() for _ in range(start_batches))
    loaders = [build_train_loader(cfg, n, mappers[i], seed=seed + i, num_workers=num_workers,
                                  start=taken[i] * bs, block=block) for i, n in enumerate(names)]
    combined = CombinedDataLoader(loaders, ratios, seed=seed)
    combined.rng = replay.rng
    return combined


def shard_records(records: Sequence, index: int, count: int) -> List:
    """Records ``index::count``: a rank's share of an eval set (the
    reference's ``InferenceSampler``: rank r evaluates ``indices[r::world]``;
    the evaluators join the rows again, ``evaluation.dist``)."""
    return list(records)[index::count]


def build_test_loader(cfg, dataset_name: str, mapper: Optional[Callable] = None,
                      dataset_type: Optional[str] = None,
                      shard: Optional[Tuple[int, int]] = None) -> Iterator[dict]:
    """The eval loader of ``dataset_name``: one mapped video at a time, the
    mapper routed by ``dataset_type`` (default: the set's entry of
    ``datasets.dataset_type_test``, else ``video_instance``). Under a
    process group each rank takes its stripe of the videos
    (:func:`shard_records`); ``shard=(i, n)`` stripes that again for a
    rank's eval workers (``engine.parallel_eval``)."""
    from dvis_plus_tpu_torch.parallel.mesh import world

    records = get_dataset(dataset_name)
    rank, world_size = world()
    if world_size > 1:
        records = shard_records(records, rank, world_size)
    if shard is not None:
        records = shard_records(records, *shard)
    if mapper is None:
        if dataset_type is None:
            names, types = list(cfg.datasets.test), list(cfg.datasets.dataset_type_test)
            idx = names.index(dataset_name) if dataset_name in names else len(types)
            dataset_type = types[idx] if idx < len(types) else "video_instance"
        mapper = mapper_for_type(cfg, dataset_type, dataset_name=dataset_name)
    return (mapper(rec, seed=0) for rec in records)
