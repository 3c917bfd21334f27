"""The ViT-Adapter (DINOv2) segmenter in training against the JAX package,
at the tiny widths of ``tests/test_torch_common.py::tiny_vit_backbone``
(a 4-block trunk of width 32, one block an interaction).

The JAX ``ViTAdapter`` stops the gradient after ``prepare_tokens`` only
(``models/backbones/vit_adapter.py:376-378``) and no code reads
``BackboneConfig.vit_frozen``, so its 24 blocks train at the backbone's
rate and their gradients enter the global-norm clip
(:func:`test_jax_default_optimizer_moves_the_trunk_the_port_does_not`). The
reference freezes the whole trunk, and so does the port with ``vit_frozen``
(the default): the trunk runs without gradients and is out of the
optimizer. So the JAX side here has the trunk's gradients zeroed and its
leaves frozen; with ``vit_frozen=false`` the port trains the blocks as the
JAX package does, and their gradients are held too. The adapter's FrozenBN
leaves (the spatial prior's ``*_bn`` and ``norm1``-``norm4``) are JAX
parameters that its default optimizer moves, buffers in the port; the JAX
step freezes them (as ``tests/test_torch_minvis_train.py`` does for the
ResNet's).

Bars: the training forward's {res2..res5} rel <= 1e-4; the adapter's
gradients (extractors, level embedding, ``up``, the spatial prior's
projections) rel <= 1e-4, the spatial prior's convolutions within 1e-2 as a
norm (its ReLU kinks, as the ResNet's); unfrozen, the blocks' gradients rel
<= 1e-4; a MinVIS and a CTVIS train step: every loss rel <= 1e-5, the
decoders' gradients rel <= 1e-4, the backbone's within 1e-2 as a norm.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.engine import optimizer as jopt
from dvis_plus_tpu.engine.trainer import Batch as JaxBatch
from dvis_plus_tpu.engine.trainer import build_optimizer as jax_build_optimizer
from dvis_plus_tpu.engine.trainer import build_train_step as jax_build_train_step
from dvis_plus_tpu.models.segmenter.segmenter import Segmenter as JaxSegmenter
from dvis_plus_tpu_torch.convert import state_dict_from_jax
from dvis_plus_tpu_torch.engine.trainer import build_train_step
from tests.test_torch_common import (
    H_IN,
    W_IN,
    port_arch_model,
    random_params,
    rel_err,
    tiny_minvis_cfg,
    tiny_vit_backbone,
)
from tests.test_torch_minvis_train import _batch, _jax_optimizer, _targets, _torch_batch, step_draws

torch.set_num_threads(2)
VIT_TRUNK = "backbone.vit_module."


@functools.cache
def _model(arch):
    """(cfg, flax Segmenter, seeded numpy params) for the tiny ViT MinVIS /
    CTVIS, with the MinVIS tests' loss weights and schedule."""
    cfg = tiny_minvis_cfg(arch)
    tiny_vit_backbone(cfg.model.backbone)
    c = cfg.model.criterion
    c.train_num_points, c.class_weight, c.mask_weight, c.dice_weight = 200, 200.0, 500.0, 500.0
    cfg.solver.max_iter, cfg.solver.warmup_iters, cfg.solver.warmup_factor = 100, 3, 0.5
    model = JaxSegmenter(cfg.model)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((2, H_IN, W_IN, 3), jnp.float32))
    return cfg, model, random_params(shapes, seed=5)


def _jax_trunk(path: str) -> bool:
    return path.split("/")[:3] == ["params", "backbone", "vit"]


def _jax_frozen_bn(path: str) -> bool:
    """The adapter's FrozenBN leaves: the spatial prior's ``*_bn`` and
    ``norm1``-``norm4`` (the JAX ResNet-style FrozenBN)."""
    parts = path.split("/")
    return "backbone" in parts and (parts[-2].endswith("_bn") or (
        parts[-3] == "backbone" and parts[-2] in ("norm1", "norm2", "norm3", "norm4")))


def _cfg(arch, frozen=True):
    cfg, _, params = _model(arch)
    cfg = copy.deepcopy(cfg)
    cfg.model.backbone.vit_frozen = frozen
    return cfg, params


def _flat(tree, names):
    return np.concatenate([np.asarray(tree[n]).ravel() for n in names])


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
def test_training_forward_and_adapter_gradients_match_jax(frozen):
    """The backbone alone in training mode on two 64x96 images: its outputs,
    and the gradients of a fixed random weighting of them."""
    cfg, params = _cfg("minvis", frozen)
    _, model, _ = _model("minvis")
    rng = np.random.RandomState(7)
    x = rng.randn(2, H_IN, W_IN, 3).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    backbone = lambda m, im: m.backbone(im)  # noqa: E731
    feats = model.apply(jparams, jnp.asarray(x), method=backbone)
    weights = {k: rng.randn(*v.shape).astype(np.float32) for k, v in feats.items()}

    def loss(p):
        out = model.apply(p, jnp.asarray(x), method=backbone)
        return sum(jnp.sum(out[k] * weights[k]) for k in sorted(out))

    jg = state_dict_from_jax({"params": jax.jit(jax.grad(loss))(jparams)["params"]})
    port = port_arch_model(cfg, params).train()
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    out = port.backbone(xt)
    total = 0
    for k in sorted(out):
        want = np.asarray(feats[k]).transpose(0, 3, 1, 2)
        assert rel_err(out[k].detach().numpy(), want) <= 1e-4, k
        total = total + (out[k] * torch.from_numpy(weights[k].transpose(0, 3, 1, 2).copy())).sum()
    total.backward()
    got = {n: p.grad for n, p in port.backbone.named_parameters(prefix="backbone")}
    trunk = [n for n in got if n.startswith(VIT_TRUNK)]
    adapter = [n for n in got if not n.startswith(VIT_TRUNK)]
    assert all(got[n] is not None for n in adapter)
    prior = [n for n in adapter if n.startswith("backbone.spm.") and ".fc" not in n]
    rest = [n for n in adapter if n not in prior]
    assert prior and rest
    g = {n: got[n].numpy() for n in adapter}
    assert rel_err(_flat(g, rest), _flat(jg, rest)) <= 1e-4
    gp, wp = _flat(g, prior), _flat(jg, prior)
    assert np.linalg.norm(gp - wp) / np.linalg.norm(wp) <= 1e-2
    # the patch and position embeddings never take a gradient, in either package
    embeds = [n for n in trunk if not n.startswith(VIT_TRUNK + "blocks.")]
    assert embeds and all(got[n] is None for n in embeds)
    assert all(not np.asarray(jg[n]).any() for n in embeds)
    blocks = [n for n in trunk if n.startswith(VIT_TRUNK + "blocks.")]
    if frozen:
        assert all(got[n] is None for n in blocks)
    else:
        gb = {n: got[n].numpy() for n in blocks}
        assert np.abs(_flat(jg, blocks)).max() > 0
        assert rel_err(_flat(gb, blocks), _flat(jg, blocks)) <= 1e-4


@functools.cache
def _jax_step(arch):
    """One JAX train step with the trunk and the FrozenBN leaves frozen
    (their gradients zeroed before the clip): (losses, raw gradients)."""
    cfg, model, params = _model(arch)
    x, labels, masks, valid, fv = _batch()
    jbatch = JaxBatch(images=jnp.asarray(x), targets=_targets(labels, masks, valid, fv)[0])
    tx = _jax_optimizer(cfg, lambda p: _jax_trunk(p) or _jax_frozen_bn(p))
    step_fn, init_state = jax_build_train_step(cfg, model, optimizer=tx)
    state = init_state(jax.tree_util.tree_map(jnp.asarray, params))
    state, m = step_fn(state, jbatch, jax.random.key(cfg.seed))
    return ({k: np.asarray(v) for k, v in m.items()},
            jax.tree_util.tree_map(np.asarray, state.opt_state[0]))


@functools.cache
def _port_step(arch):
    """One port train step: (metrics, the parameters' gradients (None where
    there is none), the trunk before, the model after)."""
    cfg, params = _cfg(arch)
    port = port_arch_model(cfg, params)
    before = {k: v.clone() for k, v in port.state_dict().items() if k.startswith(VIT_TRUNK)}
    train_step, init = build_train_step(cfg, port)
    _, m = train_step(init(), _torch_batch(), step_draws(cfg, 0, arch))
    grads = {n: None if p.grad is None else p.grad.numpy().copy() for n, p in port.named_parameters()}
    return m, grads, before, port


@pytest.mark.parametrize("arch", ["minvis", "ctvis"])
def test_train_step_matches_jax(arch):
    want, jgrads = _jax_step(arch)
    jg = state_dict_from_jax({"params": jgrads["params"]})
    m, got, _, port = _port_step(arch)
    assert sorted(m) == sorted([*want, "grad_norm"]) and ("loss_reid" in m) == (arch == "ctvis")
    for k in want:
        assert rel_err(m[k].numpy(), want[k]) <= 1e-5, k
    heads = [n for n in got if n.startswith("sem_seg_head.")]
    backbone = [n for n in got if n.startswith("backbone.") and not n.startswith(VIT_TRUNK)]
    assert heads and backbone and all(got[n] is not None for n in heads + backbone)
    assert all(got[n] is None for n in got if n.startswith(VIT_TRUNK))
    assert rel_err(_flat(got, heads), _flat(jg, heads)) <= 1e-4
    gb, wb = _flat(got, backbone), _flat(jg, backbone)
    assert np.linalg.norm(gb - wb) / np.linalg.norm(wb) <= 1e-2
    # the JAX step's raw gradients reach the blocks (zeroed before its clip here)
    assert np.abs(_flat(jg, [n for n in got if n.startswith(VIT_TRUNK + "blocks.")])).max() > 0


def test_jax_default_optimizer_moves_the_trunk_the_port_does_not():
    """The JAX package's own optimizer for the ViT MinVIS YAML
    (``build_optimizer``: nothing frozen) applied to a step's gradients with
    the trunk's left in moves every block's leaves; the port's step leaves
    the trunk as it was, outside the optimizer and without gradients."""
    cfg, model, params = _model("minvis")
    x, labels, masks, valid, fv = _batch()
    jbatch = JaxBatch(images=jnp.asarray(x), targets=_targets(labels, masks, valid, fv)[0])
    step_fn, init_state = jax_build_train_step(cfg, model, optimizer=_jax_optimizer(cfg, lambda p: False))
    state, _ = step_fn(init_state(jax.tree_util.tree_map(jnp.asarray, params)), jbatch, jax.random.key(cfg.seed))
    grads = state.opt_state[0]
    tx = jax_build_optimizer(cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = tx.update(grads, tx.init(jparams), jparams)
    moved = {jopt._path_str(p): float(jnp.abs(u).max())
             for p, u in jax.tree_util.tree_flatten_with_path(updates)[0] if _jax_trunk(jopt._path_str(p))}
    blocks = {p: v for p, v in moved.items() if "/block" in p}
    assert blocks and all(v > 0 for v in blocks.values()), blocks

    _, _, before, port = _port_step("minvis")
    after = port.state_dict()
    assert before and all(torch.equal(after[k], v) for k, v in before.items())
    assert not any(p.requires_grad for n, p in port.named_parameters() if n.startswith(VIT_TRUNK))
    assert not port.backbone.vit_module.training and port.backbone.spm.training
