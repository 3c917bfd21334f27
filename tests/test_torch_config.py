"""The port's YAML-free presets equal the JAX package's loaded configs, field
by field, for every field the port reads; and the port's own ``load_config``
(``_BASE_`` chain, dotted overrides) resolves the slices' YAMLs to the same
values as the JAX package's."""
import dataclasses

import pytest

from dvis_plus_tpu.core.config import load_config
from dvis_plus_tpu_torch import config as port_config
from dvis_plus_tpu_torch.config import (
    dvis_offline_swinl_ytvis19,
    dvis_offline_vitl_ytvis19,
    dvis_online_r50_ytvis19,
)

YAML = "configs/dvis/dvis_online_r50_ytvis19.yaml"
GROUPS = [
    "model",
    "model.backbone",
    "model.pixel_decoder",
    "model.transformer_decoder",
    "model.tracker",
    "input",
    "datasets",
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


@pytest.mark.parametrize("group", GROUPS + ["model.refiner"])
def test_vitl_offline_preset_matches_yaml(group):
    want = _get(load_config("configs/dvis/dvis_offline_vitl_ytvis19.yaml"), group)
    _assert_fields_equal(_get(dvis_offline_vitl_ytvis19(), group), want, group)


OVERRIDES = [
    "model.compute_dtype=float32",
    "model.backbone.vit_flash_attention=true",
    "model.backbone.vit_interaction_indexes=[[0,0],[1,1]]",
    "model.backbone.swin_depths=[1,1,2,1]",
    "model.pixel_decoder.conv_dim=32",
    "model.tracker.matcher_solver=jv",
    "input.min_size_test=64",
    "test.window_size=3",
    "test.offline_mf_budget_gb=0.5",
    "datasets.test=[ytvis_2019_val,ovis_val]",
    "solver.max_iter=3",  # a section the port keeps as a namespace
    "output_dir=/tmp/out",
    "seed=7",
]


@pytest.mark.parametrize("overrides", [[], OVERRIDES], ids=["plain", "overrides"])
@pytest.mark.parametrize("yaml_name", [
    "dvis_online_r50_ytvis19", "dvis_offline_swinl_ytvis19", "dvis_offline_vitl_ytvis19",
])
def test_load_config_matches_jax(yaml_name, overrides):
    path = f"configs/dvis/{yaml_name}.yaml"
    got, want = port_config.load_config(path, overrides), load_config(path, overrides)
    for group in GROUPS + ["model.refiner"]:
        _assert_fields_equal(_get(got, group), _get(want, group), group)
    assert (got.output_dir, got.seed, got.weights) == (want.output_dir, want.seed, want.weights)
    if overrides:
        assert got.solver.max_iter == 3 and got.model.backbone.vit_interaction_indexes == ((0, 0), (1, 1))


def test_load_config_rejects_a_malformed_override():
    with pytest.raises(ValueError):
        port_config.load_config(None, ["model.compute_dtype"])
