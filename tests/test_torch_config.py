"""The port's YAML-free presets equal the JAX package's loaded configs, field
by field, for every field the port reads."""
import dataclasses

import pytest

from dvis_plus_tpu.core.config import load_config
from dvis_plus_tpu_torch.config import dvis_offline_swinl_ytvis19, dvis_online_r50_ytvis19

YAML = "configs/dvis/dvis_online_r50_ytvis19.yaml"
GROUPS = [
    "model",
    "model.backbone",
    "model.pixel_decoder",
    "model.transformer_decoder",
    "model.tracker",
    "input",
    "test",
]


def _get(cfg, path):
    for p in path.split("."):
        cfg = getattr(cfg, p)
    return cfg


def _assert_fields_equal(got, want, group):
    for f in dataclasses.fields(got):
        value = getattr(got, f.name)
        if dataclasses.is_dataclass(value):
            continue
        ref = getattr(want, f.name)
        if isinstance(value, tuple):
            value, ref = list(value), list(ref)
        assert value == ref, f"{group}.{f.name}: preset {value!r} != yaml {ref!r}"


@pytest.mark.parametrize("group", GROUPS)
def test_preset_matches_yaml(group):
    _assert_fields_equal(_get(dvis_online_r50_ytvis19(), group), _get(load_config(YAML), group), group)


@pytest.mark.parametrize("group", GROUPS + ["model.refiner"])
def test_swinl_offline_preset_matches_yaml(group):
    want = _get(load_config("configs/dvis/dvis_offline_swinl_ytvis19.yaml"), group)
    _assert_fields_equal(_get(dvis_offline_swinl_ytvis19(), group), want, group)
