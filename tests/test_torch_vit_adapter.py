"""The port's ViT-Adapter backbone against the JAX ``ViTAdapter`` on the same
seeded weights (fp32): ``res2..res5`` for the default, for coarse stride-8
extractor queries, with injectors, and with the flash flag (on the CPU both
sides take their dense path), plus the stages ``prepare_tokens`` (resampled
position embedding), ``SpatialPriorModule`` and one ``Extractor``.

Tolerance: rel <= 1e-5 of each output's max (fp32 on both sides; sums taken
in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.core.config import BackboneConfig
from dvis_plus_tpu.models.backbones import vit_adapter as jax_vit
from dvis_plus_tpu_torch.convert import _vit_backbone
from dvis_plus_tpu_torch.models.backbones import vit_adapter as port_vit
from dvis_plus_tpu_torch.ops import flash_attn
from tests.test_torch_common import H_IN, W_IN, images, nchw, random_params, rel_err, tiny_vit_backbone

torch.set_num_threads(2)

TOL = 1e-5
LEVELS = ("res2", "res3", "res4", "res5")


def _port_backbone(module: port_vit.ViTAdapter, params) -> port_vit.ViTAdapter:
    sd = {}
    _vit_backbone(params["params"], sd)
    module.load_state_dict(
        {k[len("backbone."):]: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()},
        strict=True,
    )
    return module.eval()


def _pair(coarse=False, flash=False, use_injector=False, seed=5):
    """(flax module, seeded params, port module with the same weights)."""
    b = tiny_vit_backbone(BackboneConfig(), coarse, flash)
    jm = jax_vit.build_vit_adapter(b).clone(use_injector=use_injector)
    pm = port_vit.build_vit_adapter(b)
    if use_injector:
        pm = port_vit.ViTAdapter(
            embed_dim=b.vit_embed_dim, depth=b.vit_depth, num_heads=b.vit_num_heads,
            conv_inplane=b.vit_conv_inplane, deform_num_heads=b.vit_deform_num_heads,
            interaction_indexes=b.vit_interaction_indexes, use_injector=True,
        )
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, H_IN, W_IN, 3), jnp.float32))
    params = random_params(shapes, seed=seed)
    return jm, params, _port_backbone(pm, params)


@pytest.mark.parametrize("variant", ["default", "coarse", "injector", "flash"])
def test_vit_adapter_matches_jax(variant):
    jm, params, pm = _pair(coarse=variant == "coarse", flash=variant == "flash",
                           use_injector=variant == "injector")
    x = images(2, seed=31)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    flash_attn.reset_launches()
    with torch.inference_mode():
        got = pm(nchw(x))
    assert flash_attn.launches == 0  # a CPU tensor never reaches the kernel
    assert sorted(got) == sorted(want) == list(LEVELS)
    assert pm.out_channels == {k: 32 for k in LEVELS}
    for k, stride in zip(LEVELS, (4, 8, 16, 32)):
        w = np.moveaxis(np.asarray(want[k]), -1, 1)
        assert got[k].shape == w.shape == (2, 32, H_IN // stride, W_IN // stride), k
        assert rel_err(got[k], w) <= TOL, (variant, k)


def test_flash_flag_equals_dense_on_cpu():
    _, _, dense = _pair()
    _, _, flash = _pair(flash=True)
    x = nchw(images(1, seed=32))
    with torch.inference_mode():
        a, b = dense(x), flash(x)
    for k in LEVELS:
        assert torch.equal(a[k], b[k]), k


def test_prepare_tokens_resamples_pos_embed():
    jm, params, pm = _pair()
    x = images(1, seed=33)
    vit = jax_vit.DinoViT(32, 4, 2, 16)
    tokens, cls, Hp, Wp = vit.apply(
        {"params": params["params"]["vit"]}, jnp.asarray(x), method=jax_vit.DinoViT.prepare_tokens
    )
    with torch.inference_mode():
        g_tokens, g_cls, gh, gw = pm.vit_module.prepare_tokens(nchw(x))
    assert (gh, gw) == (Hp, Wp) == (4, 6) != (37, 37)
    assert rel_err(g_tokens, tokens) <= TOL
    assert rel_err(g_cls, cls) <= TOL
    np.testing.assert_array_equal(port_vit.bicubic_matrix(6, 37), jax_vit._torch_bicubic_matrix(6, 37))


def test_bicubic_matrix_is_torch_bicubic_with_the_scale_fudge():
    """The host-built matrices against ``F.interpolate`` itself, called as
    the reference calls it (scale factors with the +0.1 fudge)."""
    G, C, out = 37, 3, (4, 6)
    pe = torch.from_numpy(np.random.RandomState(0).randn(1, C, G, G).astype(np.float32))
    want = torch.nn.functional.interpolate(
        pe, scale_factor=((out[0] + 0.1) / G, (out[1] + 0.1) / G), mode="bicubic"
    )
    Mh = torch.from_numpy(port_vit.bicubic_matrix(out[0], G))
    Mw = torch.from_numpy(port_vit.bicubic_matrix(out[1], G))
    got = torch.einsum("hg,cgv,wv->chw", Mh, pe[0], Mw)
    assert want.shape[-2:] == out
    assert rel_err(got, want[0]) <= TOL


def test_spatial_prior_module_matches_jax():
    jm, params, pm = _pair()
    x = images(2, seed=34)
    want = jax_vit.SpatialPriorModule(8, 32).apply({"params": params["params"]["spm"]}, jnp.asarray(x))
    with torch.inference_mode():
        got = pm.spm(nchw(x))
    for g, w, stride in zip(got, want, (4, 8, 16, 32)):
        w = np.moveaxis(np.asarray(w), -1, 1)
        assert g.shape == w.shape == (2, 32, H_IN // stride, W_IN // stride)
        assert rel_err(g, w) <= TOL


@pytest.mark.parametrize("coarse", [False, True])
def test_extractor_matches_jax(coarse):
    """One extractor on random tokens: 126 spatial queries over the grids
    (8, 12), (4, 6), (2, 3) attend into the 4x6 ViT grid."""
    jm, params, pm = _pair(coarse=coarse)
    shapes = ((8, 12), (4, 6), (2, 3))
    rng = np.random.RandomState(35)
    query = rng.randn(2, 126, 32).astype(np.float32)
    feat = rng.randn(2, 24, 32).astype(np.float32)
    from dvis_plus_tpu.models.segmenter.pixel_decoder import _reference_points

    jax_ext = jax_vit.Extractor(32, 2, 4, shapes=shapes, coarse_s8=coarse)
    want = jax_ext.apply({"params": params["params"]["extractor_0"]}, jnp.asarray(query),
                         _reference_points(shapes)[:, 1:2], jnp.asarray(feat), (4, 6))
    refs = port_vit.reference_points(shapes)[:, 1:2]
    with torch.inference_mode():
        got = pm.interactions[0].extractor(torch.from_numpy(query), refs, torch.from_numpy(feat),
                                           (4, 6), shapes)
    assert rel_err(got, want) <= TOL
