"""The port's optimizer and DVIS++ online train step against the JAX
package's (``engine/optimizer.py``, ``engine/trainer.py::build_train_step``)
on the same weights and batch, with the JAX draws answered to the port by
site (``tests/test_torch_common.py``).

Bars: the group label and the weight-decay flag of every parameter equal the
JAX leaves' (through the weight conversion); the schedule equal at steps 0,
9, 10, 25,999 and 26,000; two AdamW updates on the same gradients, clip
included, rel <= 1e-6; one train step's losses rel <= 1e-5 and the tracker's
gradients rel <= 1e-4; the update after two steps within 1e-4 of the JAX one
as a norm (at step 1 Adam's update is about +-lr a parameter); the frozen
segmenter unchanged. fp32, exact deformable op, JV matchers."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dvis_plus_tpu.engine import optimizer as jopt
from dvis_plus_tpu.engine.trainer import Batch as JaxBatch
from dvis_plus_tpu.engine.trainer import build_loss_fn as jax_build_loss_fn
from dvis_plus_tpu.engine.trainer import build_train_step as jax_build_train_step
from dvis_plus_tpu.losses.targets import VideoTargets as JaxTargets
from dvis_plus_tpu_torch.convert import state_dict_from_jax
from dvis_plus_tpu_torch.engine import optimizer as popt
from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step
from dvis_plus_tpu_torch.losses.targets import VideoTargets
from tests.test_torch_common import (
    H_IN,
    W_IN,
    JaxDraws,
    images,
    jax_model_and_params,
    nchw,
    noise_draws,
    online_loss_draws,
    port_model,
    rel_err,
)

torch.set_num_threads(2)
T, BATCH, N = 3, 2, 4


def _cfg():
    """The tiny DVISOnline of the parity tests, trained as the YAML says
    (segmenter frozen), at 200 points and loss weights x100 (the random
    model's queries cost nearly the same, and the JAX JV solves in fp32
    beside pad costs of 1e6: scaled, the costs lie further apart than its
    resolution)."""
    cfg, model, params = jax_model_and_params()
    cfg = copy.deepcopy(cfg)  # the cached config stays as it is
    cfg.model.freeze = ("segmenter",)
    c = cfg.model.criterion
    c.train_num_points, c.class_weight, c.mask_weight, c.dice_weight = 200, 200.0, 500.0, 500.0
    cfg.solver.max_iter = 100  # matcher guidance for the first 50 steps
    cfg.solver.warmup_iters = 3
    cfg.solver.warmup_factor = 0.5
    return cfg, model, params


@pytest.mark.parametrize("freeze", [(), ("segmenter",), ("tracker",)])
def test_groups_and_decay_match_jax(freeze):
    """Every JAX leaf gets a distinct value; the converted state dict tells
    which leaves each port parameter came from."""
    cfg, _, params = jax_model_and_params()
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    ids = [np.full(np.shape(x), i + 1, np.float32) for i, (_, x) in enumerate(leaves)]
    sd = state_dict_from_jax(jax.tree_util.tree_unflatten(treedef, ids))
    frozen = jopt.make_frozen_predicate(freeze)
    jax_label, jax_decay = {}, {}
    for i, (path, x) in enumerate(leaves):
        p = jopt._path_str(path)
        jax_label[i + 1] = "frozen" if frozen(p) else ("backbone" if jopt._is_backbone(p) else "main")
        jax_decay[i + 1] = not jopt._no_weight_decay(p, np.asarray(x))
    model = port_model(cfg, params)
    pfrozen = popt.make_frozen_predicate(freeze)
    seen = set()
    for name, p in model.named_parameters():
        which = {int(v) for v in np.unique(sd[name].numpy())}
        seen |= which
        assert {jax_label[i] for i in which} == {popt.group_label(name, pfrozen)}, name
        assert {jax_decay[i] for i in which} == {not popt.no_weight_decay(name, p)}, name
    # the JAX leaves no port parameter holds are the frozen batch-norm statistics (buffers)
    for i in set(jax_label) - seen:
        assert "backbone" in jopt._path_str(leaves[i - 1][0]), jopt._path_str(leaves[i - 1][0])


def test_schedule_matches_jax():
    for factor in (1.0, 0.001):
        want = jopt.warmup_multistep_schedule(1e-4, (26000,), 0.1, 10, factor)
        got = popt.warmup_multistep_schedule(1e-4, (26000,), 0.1, 10, factor)
        for step in (0, 9, 10, 25999, 26000):
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-7)


@pytest.mark.parametrize("scale", [1.0, 1e-4], ids=["clipped", "unclipped"])
def test_adamw_updates_match_jax(scale):
    """Four parameters: a backbone conv kernel, a norm scale, a tracker
    kernel and a frozen segmenter one; freeze = (sem_seg_head,). The frozen
    gradient is zero, as the JAX model's stop-gradient makes it (the JAX clip
    takes its norm over every leaf, the port's over the trained ones)."""
    rng = np.random.RandomState(0)
    shapes = {"backbone.conv.weight": (4, 3, 3, 3), "tracker.norm.weight": (5,),
              "tracker.fc.weight": (5, 6), "sem_seg_head.fc.weight": (2, 3)}
    # small weights and a large rate, so that the updates stand well above
    # the weights' fp32 rounding; the decay still moves them by some 5e-4
    init = {k: (rng.randn(*s) * 0.01).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()} for _ in range(2)]
    for g in grads:  # a frozen parameter's gradient is zero (the JAX stop-gradient): the clip's norm
        g["sem_seg_head.fc.weight"][:] = 0.0

    def tree(flat):
        out = {}
        for k, v in flat.items():
            node = out
            *parents, leaf = k.split(".")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
        return out

    sched = jopt.warmup_multistep_schedule(0.1, (1,), 0.1, 1, 0.5)
    tx = jopt.make_optimizer(sched, frozen_predicate=jopt.make_frozen_predicate(("sem_seg_head",)))
    params = tree(init)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(tree(g), state, params)
        params = optax.apply_updates(params, updates)

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k.replace(".", "_"), torch.nn.Parameter(torch.from_numpy(v.copy())))
    named = [(k, getattr(module, k.replace(".", "_"))) for k in init]
    opt = popt.AdamW(named, popt.warmup_multistep_schedule(0.1, (1,), 0.1, 1, 0.5),
                     frozen=popt.make_frozen_predicate(("sem_seg_head",)))
    for g in grads:
        for k, p in named:
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in named:
        want = np.asarray(functools.reduce(lambda n, part: n[part], k.split("."), params))
        assert rel_err(p.detach().numpy() - init[k], want - init[k]) <= 1e-6, k
    assert not named[-1][1].requires_grad and "sem_seg_head.fc.weight" not in opt.params


def _batch(seed=3):
    rng = np.random.RandomState(seed)
    h, w = H_IN // 4, W_IN // 4
    masks = np.zeros((BATCH, N, T, h, w), bool)
    fv = np.zeros((BATCH, N, T), bool)
    for b in range(BATCH):
        for n in range(N - 1):
            y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
            for t in range(T):
                if n == 1 and t < 1:
                    continue
                masks[b, n, t, y:y + 6, x + t:x + 7 + t] = True
                fv[b, n, t] = True
    labels = rng.randint(0, 5, (BATCH, N)).astype(np.int32)
    x = np.stack([images(T, seed=31 + b) for b in range(BATCH)])
    return x, labels, masks, fv.any(-1), fv


def _step_draws(cfg, step):
    """The JAX step's draws: fold the step into key(seed), split into the
    model's key (the noise) and the loss's."""
    r1, r2 = jax.random.split(jax.random.fold_in(jax.random.key(cfg.seed), step))
    td = cfg.model.transformer_decoder
    table = noise_draws(r1, T, BATCH, td.num_queries, 2 * td.hidden_dim, "wa")
    table.update(online_loss_draws(r2, BATCH, N, T, cfg.model.tracker.num_layers - 1,
                                   _ccfg_of(cfg)))
    return JaxDraws(table)


def _ccfg_of(cfg):
    from dvis_plus_tpu.engine.trainer import criterion_config

    return criterion_config(cfg)


def _tracker(sd):
    return {k: v.detach().clone() for k, v in sd.items() if k.startswith("tracker.")}


def test_train_step_matches_jax():
    cfg, model, params = _cfg()
    x, labels, masks, valid, fv = _batch()
    jbatch = JaxBatch(images=jnp.asarray(x), targets=JaxTargets(
        labels=jnp.asarray(labels), masks=jnp.asarray(masks), valid=jnp.asarray(valid),
        frame_valid=jnp.asarray(fv)))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    loss_fn = jax_build_loss_fn(cfg, model)
    (_, (want_losses, _)), want_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), static_argnums=3)(
        jparams, jbatch, jax.random.fold_in(jax.random.key(cfg.seed), 0), 0, None)
    step_fn, init_state = jax_build_train_step(cfg, model)
    state = init_state(jparams)
    jax_totals = []
    for _ in range(2):
        state, metrics = step_fn(state, jbatch, jax.random.key(cfg.seed))
        jax_totals.append(float(metrics["total_loss"]))
    before, after = state_dict_from_jax(params), state_dict_from_jax(state.params)

    port = port_model(cfg, params)
    train_step, init = build_train_step(cfg, port)
    pstate = init()
    batch = Batch(torch.stack([nchw(v) for v in x]), VideoTargets(
        torch.from_numpy(labels).long(), torch.from_numpy(masks), torch.from_numpy(valid),
        torch.from_numpy(fv)))
    totals = []
    for step in range(2):
        pstate, m = train_step(pstate, batch, _step_draws(cfg, step))
        totals.append(float(m["total_loss"]))
        if step == 0:
            for k in want_losses:
                assert rel_err(m[k].numpy(), want_losses[k]) <= 1e-5, k
            jg = state_dict_from_jax({"params": want_g["params"]})
            names = [n for n, p in port.named_parameters() if p.requires_grad]
            assert names and all(n.startswith("tracker.") for n in names)
            got_g = np.concatenate([dict(port.named_parameters())[n].grad.numpy().ravel() for n in names])
            assert rel_err(got_g, np.concatenate([jg[n].numpy().ravel() for n in names])) <= 1e-4
    np.testing.assert_allclose(totals, jax_totals, rtol=1e-5)
    sd = port.state_dict()
    d_port = np.concatenate([(sd[k] - before[k]).numpy().ravel() for k in _tracker(sd)])
    d_jax = np.concatenate([(after[k] - before[k]).numpy().ravel() for k in _tracker(sd)])
    assert np.linalg.norm(d_port - d_jax) / np.linalg.norm(d_jax) <= 1e-4
    assert np.abs(d_jax).max() > 0
    for k, v in sd.items():  # the frozen segmenter, on both sides
        if not k.startswith("tracker."):
            assert torch.equal(v, before[k]) and torch.equal(after[k], before[k]), k
