"""Swin in training: stochastic depth and the plain window attention, and a
MinVIS step with a tiny Swin against the JAX package.

The JAX ``SwinTransformer`` drops a block's residual branch per sample with
probability ``np.linspace(0, drop_path_rate, sum(depths))[i]``, scaling a
kept branch by 1 / keep (``models/backbones/swin.py:231-237``, :287), but
the JAX ``Segmenter`` never passes ``training`` to its backbone
(``models/segmenter/segmenter.py:84``), so the JAX package trains Swin
without it. The port drops in training mode, with its coins from the
step's draws (site ``("drop_path", block, "attn" | "mlp")``); the step
parity test runs at ``swin_drop_path_rate=0``, where both packages compute
the same step. Bars: the kept share within 0.01 of 1 - rate over 40,000
samples and every kept value exactly x / keep; a MinVIS step: every loss
rel <= 1e-5, the decoders' gradients rel <= 1e-4, the backbone's within
1e-2 as a norm (the pixel decoder's ReLU kinks on the way back, as in
``tests/test_torch_minvis_train.py``).
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.engine.trainer import Batch as JaxBatch
from dvis_plus_tpu.engine.trainer import build_train_step as jax_build_train_step
from dvis_plus_tpu.models.segmenter.segmenter import Segmenter as JaxSegmenter
from dvis_plus_tpu_torch.convert import state_dict_from_jax
from dvis_plus_tpu_torch.engine.trainer import build_train_step
from dvis_plus_tpu_torch.models.backbones import swin as pswin
from dvis_plus_tpu_torch.utils.draws import Draws
from tests.test_torch_common import H_IN, W_IN, port_arch_model, random_params, rel_err, tiny_minvis_cfg
from tests.test_torch_minvis_train import (
    _batch,
    _frozen_bn,
    _jax_optimizer,
    _targets,
    _torch_batch,
    step_draws,
)

torch.set_num_threads(2)


def _draws(seed=0):
    return Draws(torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.6])
def test_drop_path_keeps_a_sample_with_probability_one_minus_rate(rate):
    x = torch.rand(40000, 3, 2) + 0.5
    y = pswin.drop_path(x, rate, _draws(int(rate * 10)), ("drop_path", 0, "attn"))
    kept = (y != 0).flatten(1).all(1)
    assert ((y == 0).flatten(1).all(1) | kept).all()  # a whole sample kept or dropped
    assert abs(kept.float().mean().item() - (1 - rate)) <= 0.01
    assert torch.equal(y[kept], x[kept] / (1 - rate))


def test_swin_blocks_drop_in_training_mode_only():
    """The blocks' rates rise linearly from 0 to ``drop_path_rate`` over the
    trunk; in training mode the output depends on the draws, in eval mode
    (and at rate 0) it does not and no draw is asked for; training mode
    without draws raises; the window attention is the plain op in training
    mode (the CPU takes it in eval too)."""
    net = pswin.SwinTransformer(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8),
                                window_size=4, drop_path_rate=0.3)
    rates = [b.drop_path for layer in net.layers for b in layer.blocks]
    assert np.allclose(rates, np.linspace(0, 0.3, 8)) and rates[0] == 0.0
    assert [b.index for layer in net.layers for b in layer.blocks] == list(range(8))
    x = torch.randn(6, 3, 64, 64)
    net.eval()
    ref = net(x)
    assert all(torch.equal(a, b) for a, b in zip(ref.values(), net(x, _draws(1)).values()))
    net.train()
    a, b = net(x, _draws(1)), net(x, _draws(2))
    assert not torch.equal(a["res5"], b["res5"])
    assert torch.equal(a["res5"], net(x, _draws(1))["res5"])
    with pytest.raises(ValueError, match="draws"):
        net(x)
    net.layers[1].blocks[0].drop_path = 0.0  # a block at rate 0 draws nothing in training mode
    asked = []

    class Recording(Draws):
        def uniform(self, site, shape):
            asked.append(site)
            return super().uniform(site, shape)

    net(x, Recording(torch.Generator().manual_seed(3)))
    assert ("drop_path", 2, "attn") not in asked and ("drop_path", 3, "mlp") in asked
    assert ("drop_path", 0, "attn") not in asked  # the first block's rate is 0


@functools.cache
def _model():
    """(cfg, flax Segmenter, seeded params): tiny MinVIS with a Swin of
    embed 32, depths (2, 2, 2, 2), heads (1, 2, 4, 8), window 7, at
    ``drop_path_rate`` 0."""
    cfg = tiny_minvis_cfg("minvis")
    b = cfg.model.backbone
    b.name, b.swin_embed_dim, b.swin_depths = "swin_tiny", 32, (2, 2, 2, 2)
    b.swin_num_heads, b.swin_window_size, b.swin_drop_path_rate = (1, 2, 4, 8), 7, 0.0
    c = cfg.model.criterion
    c.train_num_points, c.class_weight, c.mask_weight, c.dice_weight = 200, 200.0, 500.0, 500.0
    cfg.solver.max_iter, cfg.solver.warmup_iters, cfg.solver.warmup_factor = 100, 3, 0.5
    model = JaxSegmenter(cfg.model)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((2, H_IN, W_IN, 3), jnp.float32))
    return cfg, model, random_params(shapes, seed=5)


def test_minvis_swin_train_step_matches_jax():
    cfg, model, params = _model()
    x, labels, masks, valid, fv = _batch()
    jbatch = JaxBatch(images=jnp.asarray(x), targets=_targets(labels, masks, valid, fv)[0])
    step_fn, init_state = jax_build_train_step(cfg, model, optimizer=_jax_optimizer(cfg, _frozen_bn))
    state, want = step_fn(init_state(jax.tree_util.tree_map(jnp.asarray, params)), jbatch,
                          jax.random.key(cfg.seed))
    jg = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, state.opt_state[0])["params"]})

    port = port_arch_model(copy.deepcopy(cfg), params)
    train_step, init = build_train_step(cfg, port)
    assert all(blk.attn.training for layer in port.backbone.layers for blk in layer.blocks)
    _, m = train_step(init(), _torch_batch(), step_draws(cfg, 0, "minvis"))
    for k in want:
        assert rel_err(m[k].numpy(), np.asarray(want[k])) <= 1e-5, k
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    flat = lambda tree, names: np.concatenate([np.asarray(tree[n]).ravel() for n in names])  # noqa: E731
    heads = [n for n in got if n.startswith("sem_seg_head.")]
    backbone = [n for n in got if n.startswith("backbone.")]
    assert heads and backbone and len(heads) + len(backbone) == len(got)
    assert rel_err(flat(got, heads), flat(jg, heads)) <= 1e-4
    gb, wb = flat(got, backbone), flat(jg, backbone)
    assert np.linalg.norm(gb - wb) / np.linalg.norm(wb) <= 1e-2
