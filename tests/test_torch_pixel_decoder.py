"""Port MSDeformAttn pixel decoder against the JAX one, fp32, rel <= 1e-5,
under both ``msdeform_impl`` values. For ``pallas_local`` the JAX side runs
the TPU Pallas kernel in interpret mode at full fp32 precision on every
(query level, value level) pair it takes, as ``tests/test_msdeform_pallas.py``
runs it on the CPU."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvis_plus_tpu.ops.msdeform_pallas as msdeform_pallas
from dvis_plus_tpu.models.segmenter.pixel_decoder import MSDeformAttnPixelDecoder
from tests.test_torch_common import H_IN, W_IN, jax_model_and_params, port_model, rel_err

torch.set_num_threads(2)

CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}


def _features(seed=0, B=2):
    rng = np.random.RandomState(seed)
    return {
        name: rng.randn(B, H_IN // s, W_IN // s, c).astype(np.float32)
        for (name, c), s in zip(CHANNELS.items(), (4, 8, 16, 32))
    }


@pytest.mark.parametrize("impl", ["exact", "pallas_local"])
def test_pixel_decoder_matches_jax(impl, monkeypatch):
    cfg, _, params = jax_model_and_params(impl)
    windows = []
    if impl == "pallas_local":
        window = msdeform_pallas.deform_sample_window
        monkeypatch.setattr(
            msdeform_pallas, "ms_deform_attn_local",
            functools.partial(msdeform_pallas.ms_deform_attn_local, interpret=True, min_samples=0),
        )
        monkeypatch.setattr(
            msdeform_pallas, "deform_sample_window",
            lambda *a, **k: windows.append(1) or window(*a, **k),
        )
    pd = cfg.model.pixel_decoder
    jmod = MSDeformAttnPixelDecoder(
        conv_dim=pd.conv_dim, mask_dim=pd.mask_dim, num_enc_layers=pd.transformer_enc_layers,
        n_heads=pd.transformer_nheads, d_ffn=pd.transformer_dim_feedforward,
        n_points=pd.num_points, impl=impl,
    )
    feats = _features()
    jp = {"params": params["params"]["segmenter"]["pixel_decoder"]}
    mf_j, ms_j = jax.jit(jmod.apply)(jp, {k: jnp.asarray(v) for k, v in feats.items()})
    assert bool(windows) == (impl == "pallas_local")  # the Pallas kernel ran

    model = port_model(cfg, params)
    assert model.sem_seg_head.pixel_decoder.transformer.encoder.layers[0].impl == impl
    with torch.no_grad():
        mf_t, ms_t = model.sem_seg_head.pixel_decoder(
            {k: torch.from_numpy(np.moveaxis(v, -1, 1).copy()) for k, v in feats.items()}
        )
    assert rel_err(mf_t.numpy(), np.moveaxis(np.asarray(mf_j), -1, 1)) <= 1e-5
    for t, j in zip(ms_t, ms_j):
        assert rel_err(t.numpy(), np.moveaxis(np.asarray(j), -1, 1)) <= 1e-5
