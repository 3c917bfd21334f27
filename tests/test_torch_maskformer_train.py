"""Mask2Former and Video Mask2Former training (the COCO pseudo-video
recipe) against the JAX package on the same numpy inputs, the JAX draws
answered to the port by site (``tests/test_torch_common.py::JaxDraws``).

Bars: ``video_maskformer_train_loss`` every key rel <= 1e-5 on random clip
outputs (T = 1 and 2, the final and two auxiliary predictions); one
``maskformer`` step (clips of one frame) and one ``video_maskformer`` step
(clips of two frames) against ``engine/trainer.py::build_train_step`` from
the same weights, batch and draws: every loss rel <= 1e-5, the decoders'
gradients rel <= 1e-4, the backbone's within 1e-2 as a norm (the random
R50's ReLU kinks, ``tests/test_torch_minvis_train.py`` says why). fp32,
exact deformable op, JV matchers, the loss weights x100 (as the MinVIS
tests). The JAX step is built with an optimizer that zeroes and freezes
the FrozenBN leaves, which the port keeps as buffers (as the MinVIS tests
do).
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
from dvis_plus_tpu.engine.trainer import criterion_config as jax_criterion_config
from dvis_plus_tpu.losses.targets import VideoTargets as JaxTargets
from dvis_plus_tpu.models.meta import video_maskformer as jvmf
from dvis_plus_tpu_torch.convert import state_dict_from_jax
from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step, criterion_config
from dvis_plus_tpu_torch.losses.targets import VideoTargets
from dvis_plus_tpu_torch.models.meta import video_maskformer as pvmf
from tests.test_torch_common import (
    H_IN,
    W_IN,
    JaxDraws,
    add_points,
    clip_match_coords,
    jax_clip_model_and_params,
    nchw,
    port_arch_model,
    rel_err,
)
from tests.test_torch_minvis_train import _frozen_bn, _jax_optimizer

torch.set_num_threads(2)
BATCH, N = 2, 4


def clip_criterion_draws(key, B, T, n_aux, ccfg):
    """``video_criterion(key, ...)``'s draws with clip matching: split into
    2 (n_aux + 1) keys, each layer's match (B clips) then its points (a row
    a slot and frame)."""
    keys = jax.random.split(key, 2 * (n_aux + 1))
    table = {("match", "final"): clip_match_coords(keys[0], B, ccfg.num_points)}
    add_points(table, "final", keys[1], B * N * T, ccfg)
    for i in range(n_aux):
        table[("match", i)] = clip_match_coords(keys[2 + 2 * i], B, ccfg.num_points)
        add_points(table, i, keys[3 + 2 * i], B * N * T, ccfg)
    return table


def _batch(T, seed=3):
    """Clips of T frames at 64x96, targets at the stride-4 size: three
    instances a clip (a pseudo-video's frames share them), the fourth slot
    padding; with T > 1 the second instance leaves the last frame."""
    rng = np.random.RandomState(seed)
    h, w = H_IN // 4, W_IN // 4
    masks = np.zeros((BATCH, N, T, h, w), bool)
    fv = np.zeros((BATCH, N, T), bool)
    for b in range(BATCH):
        for n in range(N - 1):
            y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
            for t in range(T):
                if n == 1 and t == T - 1 and T > 1:
                    continue
                masks[b, n, t, y:y + 6, x + t:x + 7 + t] = True
                fv[b, n, t] = True
    labels = rng.randint(0, 5, (BATCH, N)).astype(np.int32)
    x = rng.randn(BATCH, T, H_IN, W_IN, 3).astype(np.float32)
    return x, labels, masks, fv.any(-1), fv


def _targets(labels, masks, valid, fv):
    return (JaxTargets(labels=jnp.asarray(labels), masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                       frame_valid=jnp.asarray(fv)),
            VideoTargets(torch.from_numpy(labels).long(), torch.from_numpy(masks),
                         torch.from_numpy(valid), torch.from_numpy(fv)))


def _cfg(arch):
    """The tiny clip model's weights; ``maskformer`` is the same tree run on
    clips of one frame."""
    cfg, model, params = jax_clip_model_and_params()
    cfg = copy.deepcopy(cfg)
    cfg.model.meta_architecture = arch
    c = cfg.model.criterion
    c.train_num_points, c.class_weight, c.mask_weight, c.dice_weight = 200, 200.0, 500.0, 500.0
    cfg.solver.max_iter, cfg.solver.warmup_iters, cfg.solver.warmup_factor = 100, 3, 0.5
    if arch == "maskformer":
        model = jvmf.ImageMaskFormer(cfg.model)
    return cfg, model, params


@pytest.mark.parametrize("T", [1, 2])
def test_video_maskformer_train_loss_matches_jax(T):
    """Random clip outputs (B, Q, K+1) and (B, Q, T, h, w), the final and
    two auxiliary predictions."""
    cfg, _, _ = _cfg("video_maskformer")
    ccfg = jax_criterion_config(cfg)
    jt, pt = _targets(*_batch(T, seed=5)[1:])
    rng = np.random.RandomState(9)
    Q, K, h, w = 8, 5, H_IN // 4, W_IN // 4
    lg = [rng.randn(BATCH, Q, K + 1).astype(np.float32) * 2 for _ in range(3)]
    mk = [rng.randn(BATCH, Q, T, h, w).astype(np.float32) * 3 for _ in range(3)]
    key = jax.random.key(11)
    want = jax.jit(lambda d, t: jvmf.video_maskformer_train_loss(key, d, t, ccfg))(
        {"pred_logits": lg[2], "pred_masks": mk[2], "aux_pred_logits": lg[:2],
         "aux_pred_masks": mk[:2]}, jt)
    got = pvmf.video_maskformer_train_loss(
        {"pred_logits": torch.from_numpy(lg[2]), "pred_masks": torch.from_numpy(mk[2]),
         "aux_pred_logits": [torch.from_numpy(x) for x in lg[:2]],
         "aux_pred_masks": [torch.from_numpy(x) for x in mk[:2]]},
        pt, criterion_config(cfg), JaxDraws(clip_criterion_draws(key, BATCH, T, 2, ccfg)))
    assert sorted(got) == sorted(want) and len(got) == 9
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k


@functools.cache
def _jax_step(arch):
    """One JAX train step: (its losses, its raw gradients)."""
    cfg, model, params = _cfg(arch)
    T = 1 if arch == "maskformer" else 2
    x, labels, masks, valid, fv = _batch(T)
    jbatch = JaxBatch(images=jnp.asarray(x), targets=_targets(labels, masks, valid, fv)[0])
    step_fn, init_state = jax_build_train_step(cfg, model, optimizer=_jax_optimizer(cfg, _frozen_bn))
    state = init_state(jax.tree_util.tree_map(jnp.asarray, params))
    state, m = step_fn(state, jbatch, jax.random.key(cfg.seed))
    return ({k: np.asarray(v) for k, v in m.items()},
            jax.tree_util.tree_map(np.asarray, state.opt_state[0]))


@pytest.mark.parametrize("arch", ["maskformer", "video_maskformer"])
def test_train_step_matches_jax(arch):
    cfg, _, params = _cfg(arch)
    T = 1 if arch == "maskformer" else 2
    want, grads = _jax_step(arch)
    jg = state_dict_from_jax({"params": grads["params"]})
    port = port_arch_model(cfg, params).train()
    x, labels, masks, valid, fv = _batch(T)
    batch = Batch(torch.stack([nchw(v) for v in x]), _targets(labels, masks, valid, fv)[1])
    key = jax.random.fold_in(jax.random.key(cfg.seed), 0)
    draws = JaxDraws(clip_criterion_draws(key, BATCH, T, cfg.model.transformer_decoder.dec_layers,
                                          jax_criterion_config(cfg)))
    train_step, init = build_train_step(cfg, port)
    _, m = train_step(init(), batch, draws)
    assert sorted(m) == sorted([*want, "grad_norm"])
    for k in want:
        assert rel_err(m[k].numpy(), want[k]) <= 1e-5, k
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    heads = [n for n in got if n.startswith("sem_seg_head.")]
    backbone = [n for n in got if n.startswith("backbone.")]
    assert heads and backbone and len(heads) + len(backbone) == len(got)
    flat = lambda tree, names: np.concatenate([np.asarray(tree[n]).ravel() for n in names])
    assert rel_err(flat(got, heads), flat(jg, heads)) <= 1e-4
    gb, wb = flat(got, backbone), flat(jg, backbone)
    assert np.linalg.norm(gb - wb) / np.linalg.norm(wb) <= 1e-2
