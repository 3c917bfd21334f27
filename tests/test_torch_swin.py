"""The port's Swin backbone against the JAX ``SwinTransformer`` on res2..res5
(fp32, rel <= 1e-5), and the Swin segmenter's pixel decoder sized from the
backbone's own widths.

The tiny Swin (``tests/test_torch_common.py::tiny_offline_cfg``) at 64x96
input pads in every stage; with window 12 the three deeper stages are one
padded window each, where the cyclic shift must stay on. Window 7 gives
several windows, a shift mask with nW > 1 and N = 49."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.models.backbones.swin import build_swin as jax_build_swin
from tests.test_torch_common import (
    images,
    jax_offline_model_and_params,
    nchw,
    port_model,
    rel_err,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("window", [12, 7])
def test_swin_backbone_matches_jax(window):
    cfg, _, params = jax_offline_model_and_params(window)
    x = images(2, seed=3)
    backbone = jax_build_swin(cfg.model.backbone, dtype=jnp.float32)
    want = backbone.apply(
        {"params": params["params"]["online"]["segmenter"]["backbone"]}, jnp.asarray(x)
    )
    model = port_model(cfg, params)
    with torch.inference_mode():
        got = model.backbone(nchw(x))
    assert sorted(got) == sorted(want) == ["res2", "res3", "res4", "res5"]
    for name, w in want.items():
        g = np.moveaxis(got[name].numpy(), 1, -1)
        assert g.shape == w.shape, name
        assert rel_err(g, w) <= 1e-5, name


def test_swin_segmenter_sizes_pixel_decoder_from_backbone():
    """Repair of the hard-coded ResNet widths: the Swin segmenter's input
    projections take 32/64/128/256 channels and the JAX weights load
    strictly (``port_model`` loads with ``strict=True``)."""
    cfg, _, params = jax_offline_model_and_params(12)
    model = port_model(cfg, params)
    assert model.backbone.out_channels == {"res2": 32, "res3": 64, "res4": 128, "res5": 256}
    pd = model.sem_seg_head.pixel_decoder
    assert [p[0].in_channels for p in pd.input_proj] == [256, 128, 64]  # res5, res4, res3
    assert pd.adapter_1.in_channels == 32
    keys = model.state_dict().keys()
    assert "backbone.layers.0.blocks.1.attn.relative_position_index" in keys
    assert "backbone.norm3.weight" in keys and "backbone.layers.3.downsample.norm.weight" not in keys
