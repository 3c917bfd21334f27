"""Dataset and metadata catalogs: a dataset name maps to a lazy loader
returning a list of video records, and to a metadata namespace (thing
classes, id maps, json paths).

Counterpart: ``dvis_plus_tpu/data/catalog.py``; the port keeps its own copy so
that it imports nothing of the JAX package.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, List

_DATASETS: Dict[str, Callable[[], List[dict]]] = {}
_METADATA: Dict[str, SimpleNamespace] = {}


def register_dataset(name: str, loader: Callable[[], List[dict]], **metadata) -> None:
    _DATASETS[name] = loader
    _METADATA[name] = SimpleNamespace(name=name, **metadata)


def get_dataset(name: str) -> List[dict]:
    if name not in _DATASETS:
        raise KeyError(f"Dataset not registered: {name}. Known: {list(_DATASETS)}")
    return _DATASETS[name]()


def get_metadata(name: str) -> SimpleNamespace:
    return _METADATA[name]


def is_registered(name: str) -> bool:
    return name in _DATASETS


def list_datasets() -> List[str]:
    return sorted(_DATASETS)
