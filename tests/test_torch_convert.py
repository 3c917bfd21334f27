"""Weights carried across: JAX DVISOnline / DVISOffline params <-> the port's
state_dict.

The port keeps the reference checkpoints' key space, so its ``state_dict``
converts back to the JAX tree with the JAX package's own zoo converter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.core.zoo_convert import convert_reference_checkpoint
from dvis_plus_tpu_torch.convert import state_dict_from_jax
from dvis_plus_tpu_torch.models.meta.dvis_online import DVISOnline as TorchDVISOnline
from tests.test_torch_common import (
    H_IN,
    W_IN,
    jax_daq_model_and_params,
    jax_model_and_params,
    random_params,
    tiny_cfg,
    tiny_offline_cfg,
    tiny_vit_offline_cfg,
)

torch.set_num_threads(2)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): np.asarray(tree)}


def test_jax_init_loads_strict_with_no_key_left_over():
    from dvis_plus_tpu.models.meta.dvis_online import DVISOnline

    cfg = tiny_cfg(enc_layers=1, tracker_layers=1)
    params = jax.jit(DVISOnline(cfg.model).init)(
        jax.random.key(0), jnp.zeros((1, 1, H_IN, W_IN, 3), jnp.float32)
    )
    sd = state_dict_from_jax(jax.device_get(params))
    model = TorchDVISOnline(cfg.model)
    missing, unexpected = model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    # every JAX leaf landed somewhere: same parameter count on both sides
    n_jax = sum(v.size for v in _flat(params).values())
    assert n_jax == sum(t.numel() for t in model.state_dict().values())
    want = np.asarray(params["params"]["segmenter"]["pixel_decoder"]["encoder_layer_0"]
                      ["sampling_offsets"]["bias"])
    got = model.state_dict()[
        "sem_seg_head.pixel_decoder.transformer.encoder.layers.0.self_attn.sampling_offsets.bias"
    ].numpy()
    np.testing.assert_array_equal(got, want)


def test_round_trip_through_zoo_converter():
    cfg, _, params = jax_model_and_params()
    model = TorchDVISOnline(cfg.model)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = _flat(convert_reference_checkpoint(sd, cfg))
    orig = _flat(params)
    assert sorted(back) == sorted(orig)
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k], err_msg=k)


def test_offline_swin_round_trip_through_zoo_converter():
    """Swin-T offline (the smallest Swin the zoo converter routes): the JAX
    DVISOffline tree loads strictly, and the port's state_dict converts back
    through ``convert_reference_checkpoint`` leaf for leaf. Shapes only come
    from ``jax.eval_shape``: no forward runs."""
    from dvis_plus_tpu.models.meta.dvis_offline import DVISOffline
    from dvis_plus_tpu_torch.models.meta.dvis_offline import DVISOffline as TorchDVISOffline

    cfg = tiny_offline_cfg(backbone="swin_t")
    shapes = jax.eval_shape(
        DVISOffline(cfg.model).init, jax.random.key(0),
        jnp.zeros((1, 2, H_IN, W_IN, 3), jnp.float32),
    )
    params = random_params(shapes, seed=7)
    model = TorchDVISOffline(cfg.model)
    missing, unexpected = model.load_state_dict(state_dict_from_jax(params), strict=True)
    assert not missing and not unexpected
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert sum(k.startswith("backbone.layers.2.blocks.") and k.endswith(".attn.qkv.weight")
               for k in sd) == 6  # Swin-T depths (2, 2, 6, 2)
    back = _flat(convert_reference_checkpoint(sd, cfg))
    orig = _flat(params)
    assert sorted(back) == sorted(orig)
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k], err_msg=k)


def test_offline_vit_round_trip_through_zoo_converter():
    """ViT-Adapter offline: the JAX DVISOffline tree loads strictly (fused
    ``attn.qkv``, the mirrored ``up`` kernel, the shared depthwise conv), and
    the port's state_dict converts back through
    ``convert_reference_checkpoint`` leaf for leaf."""
    from dvis_plus_tpu.models.meta.dvis_offline import DVISOffline
    from dvis_plus_tpu_torch.models.meta.dvis_offline import DVISOffline as TorchDVISOffline

    cfg = tiny_vit_offline_cfg()
    shapes = jax.eval_shape(
        DVISOffline(cfg.model).init, jax.random.key(0),
        jnp.zeros((1, 2, H_IN, W_IN, 3), jnp.float32),
    )
    params = random_params(shapes, seed=8)
    model = TorchDVISOffline(cfg.model)
    missing, unexpected = model.load_state_dict(state_dict_from_jax(params), strict=True)
    assert not missing and not unexpected
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert sd["backbone.vit_module.blocks.3.attn.qkv.weight"].shape == (96, 32)
    assert sd["backbone.interactions.3.extra_extractors.1.ffn.dwconv.dwconv.weight"].shape == (8, 1, 3, 3)
    assert not any(".injector." in k for k in sd)
    up = np.asarray(params["params"]["online"]["segmenter"]["backbone"]["up"]["kernel"])
    np.testing.assert_array_equal(sd["backbone.up.weight"][3, 5], up[::-1, ::-1, 3, 5])
    back = _flat(convert_reference_checkpoint(sd, cfg))
    orig = _flat(params)
    assert sorted(back) == sorted(orig)
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k], err_msg=k)


@pytest.mark.parametrize("arch", ["daq_online", "daq_offline"])
def test_daq_round_trip_through_zoo_converter(arch):
    """DVIS-DAQ (the cutter as ``tracker.*``, the refiner as ``refiner.*``):
    the JAX tree loads into the port strictly, every JAX leaf lands in the
    state dict, and the port's state dict converts back through
    ``convert_reference_checkpoint`` (its ``convert_daq_cutter`` branch)
    leaf for leaf."""
    from dvis_plus_tpu_torch.cli import build_model
    cfg, _, params, _ = jax_daq_model_and_params(arch)
    model = build_model(cfg.model)
    missing, unexpected = model.load_state_dict(state_dict_from_jax(params), strict=True)
    assert not missing and not unexpected
    orig = _flat(params)
    assert sum(v.size for v in orig.values()) == sum(t.numel() for t in model.state_dict().values())
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = _flat(convert_reference_checkpoint(sd, cfg))
    assert sorted(back) == sorted(orig)
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k], err_msg=k)
    assert any("slot_cross_1/slot_attn/project_q_dense" in k for k in orig)
