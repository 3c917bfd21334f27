"""A configuration file -> the benchmarked package's ``Config``.

The file holds the whole configuration as it is run (``config``: every
section as the package's ``config.load_config`` resolves the YAML it names,
with the keys under ``changed`` applied). The harness builds the package's
``Config`` from that and nothing else, so a later edit to a YAML moves no
cell."""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List


def flatten(tree: Dict[str, Any], prefix: str = "") -> List[str]:
    """{"model": {"num_classes": 124}} -> ["model.num_classes=124"]."""
    out = []
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out += flatten(v, key + ".")
        else:
            out.append(f"{key}={json.dumps(v)}")
    return out


def build(cfg_file: Dict[str, Any], extra: Iterable[str] = ()):
    """The package's ``Config`` of ``cfg_file["config"]``, then ``extra``
    overrides (the CPU tests' small widths)."""
    from dvis_plus_tpu_torch.config import load_config

    return load_config(None, flatten(cfg_file["config"]) + list(extra))


def namespace(cfg_file: Dict[str, Any], extra: Iterable[str] = ()):
    """The same configuration as plain nested namespaces, for the reference,
    which imports nothing of the package; ``extra`` as in :func:`build`."""
    import yaml
    from types import SimpleNamespace

    tree = json.loads(json.dumps(cfg_file["config"]))
    for ov in extra:
        key, _, value = ov.partition("=")
        *path, leaf = key.strip().lower().split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = yaml.safe_load(value)

    def ns(x):
        return SimpleNamespace(**{k: ns(v) for k, v in x.items()}) if isinstance(x, dict) else x

    return ns(tree)
