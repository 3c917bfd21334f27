"""The port's FPN pixel decoder (``FPNPixelDecoder``) against the JAX
package's, fp32: the module alone with 0 and 1 encoder layers, at feature
sizes that are exact doubles of each other and at odd ones (a ResNet on a
60x92 input: 15x23, 8x12, 4x6, 2x3, where the nearest upsample's half-pixel
sampling matters), rel <= 5e-6; a ``Segmenter`` with
``pixel_decoder.name=fpn`` (the MinVIS model) rel <= 1e-5; and one DVIS++
online train step with it (backbone frozen, so the FPN decoder, the query
decoder and the tracker train) against the JAX ``build_train_step``: losses
rel <= 1e-5, the trained gradients rel <= 1e-4. No kernel runs on this
path."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.models.segmenter.pixel_decoder import FPNPixelDecoder as JaxFPN
from dvis_plus_tpu_torch import convert
from dvis_plus_tpu_torch.models.segmenter.pixel_decoder import FPNPixelDecoder
from tests.test_torch_common import H_IN, W_IN, images, nchw, random_params, rel_err, tiny_cfg

torch.set_num_threads(2)

CHANNELS = {"res2": 16, "res3": 24, "res4": 32, "res5": 40}
SIZES = {"doubles": ((16, 24), (8, 12), (4, 6), (2, 3)),
         "odd": ((15, 23), (8, 12), (4, 6), (2, 3))}


def _features(sizes, seed=0, B=2):
    rng = np.random.RandomState(seed)
    return {name: rng.randn(B, h, w, c).astype(np.float32)
            for (name, c), (h, w) in zip(CHANNELS.items(), sizes)}


def _port_decoder(params, enc_layers):
    out = {}
    convert._pixel_decoder(params, out)
    pre = "sem_seg_head.pixel_decoder."
    sd = {k[len(pre):]: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}
    model = FPNPixelDecoder(CHANNELS, conv_dim=32, mask_dim=16, transformer_enc_layers=enc_layers,
                            n_heads=4, d_ffn=64)
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.mark.parametrize("sizes", sorted(SIZES))
@pytest.mark.parametrize("enc_layers", [0, 1])
def test_fpn_module_matches_jax(enc_layers, sizes):
    jmod = JaxFPN(conv_dim=32, mask_dim=16, transformer_enc_layers=enc_layers, n_heads=4, d_ffn=64)
    feats = _features(SIZES[sizes])
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), jfeats)
    params = random_params(shapes["params"], seed=5, scale=0.2)
    mf_j, outs_j = jax.jit(jmod.apply)({"params": params}, jfeats)

    model = _port_decoder(params, enc_layers)
    with torch.no_grad():
        mf_t, outs_t = model({k: nchw(v) for k, v in feats.items()})
    assert mf_t.dtype == torch.float32 and len(outs_t) == 3
    assert rel_err(mf_t.numpy(), np.moveaxis(np.asarray(mf_j), -1, 1)) <= 5e-6
    for t, j in zip(outs_t, outs_j):
        assert rel_err(t.numpy(), np.moveaxis(np.asarray(j), -1, 1)) <= 5e-6


def test_upsample_is_half_pixel_nearest():
    """``nearest-exact`` is ``jax.image.resize``'s nearest at a ratio that
    is not a whole number; plain ``nearest`` is not."""
    x = np.random.RandomState(0).randn(1, 8, 12, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 15, 23, 3), "nearest"))
    got = torch.nn.functional.interpolate(nchw(x), size=(15, 23), mode="nearest-exact")
    floor = torch.nn.functional.interpolate(nchw(x), size=(15, 23), mode="nearest")
    np.testing.assert_array_equal(np.moveaxis(got.numpy(), 1, -1), want)
    assert not np.array_equal(np.moveaxis(floor.numpy(), 1, -1), want)


def _fpn_cfg(arch):
    cfg = tiny_cfg()
    cfg.model.meta_architecture = arch
    cfg.model.pixel_decoder.name = "fpn"
    if arch == "minvis":
        cfg.model.transformer_decoder.reid_branch = False
    return cfg


@functools.cache
def _jax_model_and_params(arch):
    from train_net_video import build_model

    cfg = _fpn_cfg(arch)
    model = build_model(cfg)
    x = jnp.zeros((2, H_IN, W_IN, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.key(0), x if arch == "minvis" else x[None])
    return cfg, model, random_params(shapes, seed=7)


def test_segmenter_with_fpn_matches_jax():
    from dvis_plus_tpu_torch.cli import build_model
    from dvis_plus_tpu_torch.models.segmenter.pixel_decoder import FPNPixelDecoder as Port

    cfg, model, params = _jax_model_and_params("minvis")
    x = images(3)
    want = jax.jit(model.apply)(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    port = build_model(cfg.model)
    assert isinstance(port.sem_seg_head.pixel_decoder, Port)
    port.load_state_dict(convert.state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = port.eval()(nchw(x))
    for key in ("pred_logits", "pred_masks", "pred_embds"):
        assert rel_err(got[key].numpy(), np.asarray(want[key])) <= 1e-5, key


def _step_parity(arch, cfg, model, params, x, jtargets, ptargets, draws):
    """One JAX ``build_loss_fn`` gradient against one port train step on
    the same weights and batch: the losses rel <= 1e-5, the gradients of
    every parameter the port trains rel <= 1e-4. Returns those names."""
    from dvis_plus_tpu.engine.trainer import Batch as JaxBatch
    from dvis_plus_tpu.engine.trainer import build_loss_fn as jax_build_loss_fn
    from dvis_plus_tpu_torch.cli import build_model
    from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step

    loss_fn = jax_build_loss_fn(cfg, model)
    (_, (want_losses, _)), want_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                                            static_argnums=3)(
        jax.tree_util.tree_map(jnp.asarray, params), JaxBatch(images=jnp.asarray(x), targets=jtargets),
        jax.random.fold_in(jax.random.key(cfg.seed), 0), 0, None)
    port = build_model(cfg.model)
    port.load_state_dict(convert.state_dict_from_jax(params), strict=True)
    train_step, init = build_train_step(cfg, port.train())
    _, m = train_step(init(), Batch(torch.stack([nchw(v) for v in x]), ptargets), draws)
    for k in want_losses:
        assert rel_err(m[k].numpy(), want_losses[k]) <= 1e-5, k
    jg = convert.state_dict_from_jax({"params": want_g["params"]})
    named = dict(port.named_parameters())
    names = [n for n, p in named.items() if p.requires_grad]
    got = np.concatenate([named[n].grad.numpy().ravel() for n in names])
    assert rel_err(got, np.concatenate([jg[n].numpy().ravel() for n in names])) <= 1e-4
    return names


def _weighted(cfg):
    """The loss weights x100 and 200 points, as the other step-parity tests
    (the random model's queries cost nearly the same otherwise)."""
    cfg = copy.deepcopy(cfg)
    c = cfg.model.criterion
    c.train_num_points, c.class_weight, c.mask_weight, c.dice_weight = 200, 200.0, 500.0, 500.0
    cfg.solver.max_iter = 100
    return cfg


def test_online_train_step_with_fpn_matches_jax():
    """DVIS++ online as its YAML trains it (the segmenter frozen): the FPN
    decoder in the forward, the tracker's gradients."""
    from dvis_plus_tpu.losses.targets import VideoTargets as JaxTargets
    from dvis_plus_tpu_torch.losses.targets import VideoTargets
    from tests.test_torch_train import _batch, _step_draws

    cfg, model, params = _jax_model_and_params("dvis_online")
    cfg = _weighted(cfg)
    cfg.model.freeze = ("segmenter",)
    x, labels, masks, valid, fv = _batch()
    jt = JaxTargets(labels=jnp.asarray(labels), masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                    frame_valid=jnp.asarray(fv))
    pt = VideoTargets(torch.from_numpy(labels).long(), torch.from_numpy(masks),
                      torch.from_numpy(valid), torch.from_numpy(fv))
    names = _step_parity("dvis_online", cfg, model, params, x, jt, pt, _step_draws(cfg, 0))
    assert names and all(n.startswith("tracker.") for n in names)


def test_minvis_train_step_with_fpn_matches_jax():
    """MinVIS (stage 1) with the backbone frozen: the FPN decoder's own
    gradients, beside the query decoder's."""
    from tests.test_torch_minvis_train import _batch, _targets, step_draws

    cfg, model, params = _jax_model_and_params("minvis")
    cfg = _weighted(cfg)
    cfg.model.freeze = ("backbone",)
    x, labels, masks, valid, fv = _batch()
    jt, pt = _targets(labels, masks, valid, fv)
    names = _step_parity("minvis", cfg, model, params, x, jt, pt, step_draws(cfg, 0, "minvis"))
    assert any(".pixel_decoder.adapter_" in n for n in names)
    assert not any(n.startswith("backbone.") for n in names)


def test_offline_video_with_fpn_matches_jax():
    """DVIS++ offline's eval forward (the online stack over three windows,
    the last ragged, then the refiner) with the FPN decoder: the JAX eval
    loop's ``_online_video`` against the port's, rel <= 1e-4 (the bar of
    ``tests/test_torch_dvis_offline.py``)."""
    import dvis_plus_tpu.engine.inference as jax_inference
    import dvis_plus_tpu_torch.engine.inference as port_inference
    from dvis_plus_tpu_torch.cli import build_model

    cfg, model, params = _jax_model_and_params("dvis_offline")
    x = images(7, seed=21)
    wl, wm, wa = jax_inference._online_video(cfg, model, params, x, {}, 3)
    port = build_model(cfg.model)
    port.load_state_dict(convert.state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        gl, gm, ga = port_inference._online_video(cfg, port.eval(), x, 3)
    assert gm.shape == (8, 7, H_IN // 4, W_IN // 4)
    assert rel_err(gl.numpy(), np.asarray(wl)) <= 1e-4
    assert rel_err(ga.numpy(), np.asarray(wa)) <= 1e-4
    assert rel_err(gm.float().numpy(), np.asarray(wm[:, :7], np.float32)) <= 1e-4


def test_daq_video_with_fpn_runs():
    """DVIS-DAQ online's eval forward builds its segmenter with the FPN
    decoder too (the JAX ``DAQOnline`` takes the JAX ``Segmenter``): the
    stream runs over 7 frames, its outputs finite and shaped as the
    sequence table's."""
    from dvis_plus_tpu_torch.cli import build_model
    from dvis_plus_tpu_torch.engine.daq_inference import daq_video_logits_masks
    from dvis_plus_tpu_torch.models.segmenter.pixel_decoder import FPNPixelDecoder as Port
    from tests.test_torch_common import tiny_daq_cfg

    cfg = tiny_daq_cfg()
    cfg.model.pixel_decoder.name = "fpn"
    torch.manual_seed(0)
    model = build_model(cfg.model).eval()
    assert isinstance(model.sem_seg_head.pixel_decoder, Port)
    with torch.inference_mode():
        logits, masks = daq_video_logits_masks(cfg, model, images(7, seed=4))
    assert logits.shape[0] == masks.shape[0] and masks.shape[1:] == (7, H_IN // 4, W_IN // 4)
    assert torch.isfinite(logits).all() and torch.isfinite(masks.float()).all()
