"""DVIS++ offline training (stage 3 of the recipe: the temporal refiner on
the frozen online model) against the JAX package on the same numpy inputs,
with the JAX draws answered to the port by site
(``tests/test_torch_common.py::JaxDraws``).

Bars: the class memory's pushes equal (the same embeddings in the same ring
rows, the same counts); ``reid_loss_with_memory`` rel <= 1e-5 and its
gradient rel <= 1e-4; the refiner's training forward, every layer's logits
and masks rel <= 1e-5; ``dvis_offline_train_loss`` every key rel <= 1e-5,
guided by the tracker and matched on its own outputs; one train step of the
tiny R50 DVIS++ offline against ``engine/trainer.py::build_train_step``:
every loss of two steps rel <= 1e-5, the refiner's gradients rel <= 1e-4,
the update after two steps within 1e-4 as a norm, the frozen segmenter and
tracker unchanged, and the class memory after two steps: the same counts
and rows, the embeddings rel <= 1e-5 (they are the refiner's outputs).
fp32, exact deformable op, JV matchers, loss weights x100 (as
``tests/test_torch_train.py``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dvis_plus_tpu.engine.trainer import Batch as JaxBatch
from dvis_plus_tpu.engine.trainer import build_optimizer as jax_build_optimizer
from dvis_plus_tpu.engine.trainer import build_train_step as jax_build_train_step
from dvis_plus_tpu.engine.trainer import criterion_config as jax_criterion_config
from dvis_plus_tpu.losses.reid import ClassMemory as JaxMemory
from dvis_plus_tpu.losses.reid import reid_loss_with_memory as jax_reid_loss_with_memory
from dvis_plus_tpu.models.meta import dvis_offline as joff
from dvis_plus_tpu_torch.convert import state_dict_from_jax
from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step, criterion_config
from dvis_plus_tpu_torch.losses.reid import ClassMemory, reid_loss_with_memory
from dvis_plus_tpu_torch.models.meta import dvis_offline as poff
from tests.test_torch_common import (
    H_IN,
    W_IN,
    JaxDraws,
    add_points,
    clip_match_coords,
    nchw,
    port_model,
    random_params,
    rel_err,
    tiny_cfg,
)
from tests.test_torch_minvis_train import _batch, _capture, _targets

torch.set_num_threads(2)
T, BATCH, N, K, MEM = 3, 2, 4, 5, 20


@functools.cache
def _jax_model():
    """(cfg, flax DVISOffline, seeded numpy params): the tiny R50 DVIS++
    offline, segmenter and tracker frozen as its YAML says, trained with the
    class memory."""
    cfg = tiny_cfg()
    m = cfg.model
    m.meta_architecture = "dvis_offline"
    m.freeze = ("segmenter", "tracker")
    m.refiner.num_layers, m.refiner.feedforward_dim, m.refiner.num_heads = 2, 64, 4
    c = m.criterion
    c.train_num_points, c.class_weight, c.mask_weight, c.dice_weight = 64, 200.0, 500.0, 500.0
    cfg.solver.max_iter = 100
    cfg.solver.warmup_iters = 3
    cfg.solver.warmup_factor = 0.5
    model = joff.DVISOffline(m)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 2, H_IN, W_IN, 3), jnp.float32))
    return cfg, model, random_params(shapes, seed=7)


def _memory(seed=2, C=64):
    """A class memory with one class empty, one partly filled and one whose
    ring has wrapped."""
    rng = np.random.RandomState(seed)
    embeds = np.zeros((K, MEM, C), np.float32)
    count = np.array([0, 7, 26, 3, 0], np.int32)
    for k in range(K):
        n = min(count[k], MEM)
        embeds[k, :n] = rng.randn(n, C)
    return embeds, count


def _assignment(seed):
    rng = np.random.RandomState(seed)
    q4g = np.stack([rng.permutation(8)[:N] for _ in range(BATCH)]).astype(np.int32)
    labels = rng.randint(0, K, (BATCH, N)).astype(np.int32)
    labels[0, :2] = 2  # two instances of the wrapped class
    valid = np.ones((BATCH, N), bool)
    valid[1, 3] = False
    return q4g, labels, valid


def test_memory_loss_and_pushes_match_jax():
    rng = np.random.RandomState(3)
    Q, C = 8, 64
    refs = rng.randn(BATCH, T, Q, C).astype(np.float32)
    q4g, labels, valid = _assignment(4)
    embeds, count = _memory(C=C)
    mem = JaxMemory(jnp.asarray(embeds), jnp.asarray(count))

    def f(r):
        losses, new = jax_reid_loss_with_memory(r, jnp.asarray(q4g), jnp.asarray(valid),
                                               jnp.asarray(labels), mem)
        return losses["loss_reid"], losses["loss_aux_reid"], new

    for i, name in enumerate(("loss_reid", "loss_aux_reid")):
        out = jax.jit(f)(jnp.asarray(refs))
        want_g = np.asarray(jax.jit(jax.grad(lambda r: f(r)[i]))(jnp.asarray(refs)))
        r = torch.from_numpy(refs).requires_grad_()
        got, new = reid_loss_with_memory(
            r, torch.from_numpy(q4g).long(), torch.from_numpy(valid), torch.from_numpy(labels).long(),
            ClassMemory(torch.from_numpy(embeds), torch.from_numpy(count).long()))
        assert rel_err(got[name].detach().numpy(), out[i]) <= 1e-5, name
        got[name].backward()
        assert rel_err(r.grad.numpy(), want_g) <= 1e-4, name
        want_new = out[2]
        assert np.array_equal(new.count.numpy(), np.asarray(want_new.count))
        assert np.array_equal(new.embeds.numpy(), np.asarray(want_new.embeds))
    assert not np.array_equal(new.embeds.numpy(), embeds)


def test_refiner_training_forward_matches_jax():
    """Every layer's predictions (the final one and the auxiliary ones) and
    the embeddings the memory loss takes."""
    cfg, model, params = _jax_model()
    rng = np.random.RandomState(6)
    C, fQ, HM, WM, CM = 64, 8, 16, 24, 32
    inst = rng.randn(BATCH, T, 8, C).astype(np.float32)
    frame = rng.randn(BATCH, T, fQ, C).astype(np.float32)
    mf = rng.randn(BATCH, T, HM, WM, CM).astype(np.float32)
    want = model.apply(params, jnp.asarray(inst), jnp.asarray(frame), jnp.asarray(mf),
                       method=lambda m, *a: m.refiner(*a, training=True))
    port = port_model(cfg, params)
    got = port.refiner(torch.from_numpy(inst), torch.from_numpy(frame),
                       torch.from_numpy(np.ascontiguousarray(np.moveaxis(mf, -1, 2))), training=True)
    assert len(got["aux_pred_logits"]) == len(want["aux_pred_logits"]) == cfg.model.refiner.num_layers - 1
    for k in ("pred_logits", "pred_masks", "pred_embds"):
        assert rel_err(got[k].detach().numpy(), want[k]) <= 1e-5, k
    for k in ("aux_pred_logits", "aux_pred_masks"):
        for i, (g, w) in enumerate(zip(got[k], want[k])):
            assert g.shape == w.shape and rel_err(g.detach().numpy(), w) <= 1e-5, (k, i)


def offline_loss_draws(key, B, n_aux, ccfg, T_):
    """``dvis_offline_train_loss(key, ...)``'s draws: rng_m, rng_l =
    split(key); the final layer's match points from rng_m (guided and self
    alike), auxiliary layer i's from split(rng_m)[i]; the loss points from
    split(rng_l), one row an instance slot of the flattened clip."""
    rng_m, rng_l = jax.random.split(key)
    P = ccfg.num_points * T_
    flat = ccfg._replace(num_points=P)
    table = {("match", "final"): clip_match_coords(rng_m, B, P)}
    for i, k in enumerate(jax.random.split(rng_m, n_aux + 1)[:n_aux]):
        table[("match", i)] = clip_match_coords(k, B, P)
    lkeys = jax.random.split(rng_l, n_aux + 1)
    add_points(table, "final", lkeys[0], B * N, flat)
    for i in range(n_aux):
        add_points(table, i, lkeys[1 + i], B * N, flat)
    return table


@pytest.mark.parametrize("guided", [True, False], ids=["guided", "self"])
def test_offline_train_loss_matches_jax(guided):
    cfg, _, _ = _jax_model()
    jccfg = jax_criterion_config(cfg)
    rng = np.random.RandomState(8)
    Q, h, w, C = 8, H_IN // 4, W_IN // 4, 64
    _, labels, masks, valid, fv = _batch(seed=9)
    jt, pt = _targets(labels % K, masks, valid, fv)

    def layer():
        lg = np.repeat(rng.randn(BATCH, 1, Q, K + 1).astype(np.float32) * 2, T, axis=1)
        return lg, rng.randn(BATCH, Q, T, h, w).astype(np.float32) * 3

    (lg, mk), aux = layer(), [layer()]
    embds = rng.randn(BATCH, T, Q, C).astype(np.float32)
    track = {"pred_logits": rng.randn(BATCH, T, Q, K + 1).astype(np.float32) * 2,
             "pred_masks": rng.randn(BATCH, Q, T, h, w).astype(np.float32) * 3}
    memory = _memory(C=C)
    key = jax.random.key(13)
    want, want_mem = jax.jit(lambda tr, ro, t, mem: joff.dvis_offline_train_loss(
        key, tr, ro, t, jccfg, jnp.asarray(guided), memory=JaxMemory(*mem)))(
        track, {"pred_logits": lg, "pred_masks": mk, "aux_pred_logits": [aux[0][0]],
                "aux_pred_masks": [aux[0][1]], "pred_embds": embds}, jt, memory)
    t = torch.from_numpy
    got, got_mem = poff.dvis_offline_train_loss(
        {k: t(v) for k, v in track.items()},
        {"pred_logits": t(lg), "pred_masks": t(mk), "aux_pred_logits": [t(aux[0][0])],
         "aux_pred_masks": [t(aux[0][1])], "pred_embds": t(embds)},
        pt, criterion_config(cfg), guided, JaxDraws(offline_loss_draws(key, BATCH, 1, jccfg, T)),
        ClassMemory(t(memory[0]), t(memory[1]).long()))
    assert sorted(got) == sorted(want) and "loss_reid" in got and "loss_dice_0" in got
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k
    assert np.array_equal(got_mem.count.numpy(), np.asarray(want_mem.count))
    assert np.array_equal(got_mem.embeds.numpy(), np.asarray(want_mem.embeds))


@functools.cache
def _jax_steps():
    cfg, model, params = _jax_model()
    x, labels, masks, valid, fv = _batch()
    jbatch = JaxBatch(images=jnp.asarray(x), targets=_targets(labels % K, masks, valid, fv)[0])
    # the package's own optimizer, with a first stage that keeps the raw gradients
    step_fn, init_state = jax_build_train_step(cfg, model, optimizer=optax.chain(
        _capture(), jax_build_optimizer(cfg)))
    state = init_state(jax.tree_util.tree_map(jnp.asarray, params))
    metrics, grads = [], None
    for step in range(2):
        state, m = step_fn(state, jbatch, jax.random.key(cfg.seed))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
        if step == 0:
            grads = jax.tree_util.tree_map(np.asarray, state.opt_state[0])
    return metrics, grads, jax.tree_util.tree_map(np.asarray, state.params), state.memory


def _step_draws(cfg, step):
    """fold the step into key(seed); split: the model's key (unused: the
    tracker runs without noise) and the loss's."""
    _, r2 = jax.random.split(jax.random.fold_in(jax.random.key(cfg.seed), step))
    return JaxDraws(offline_loss_draws(r2, BATCH, cfg.model.refiner.num_layers - 1,
                                       jax_criterion_config(cfg), T))


def test_train_step_matches_jax():
    cfg, model, params = _jax_model()
    metrics, grads, after_params, want_mem = _jax_steps()
    x, labels, masks, valid, fv = _batch()
    batch = Batch(torch.stack([nchw(v) for v in x]), _targets(labels % K, masks, valid, fv)[1])
    port = port_model(cfg, params).train()
    train_step, init = build_train_step(cfg, port)
    state = init()
    assert state.memory.embeds.shape == (K, MEM, 64) and int(state.memory.count.sum()) == 0
    for step in range(2):
        state, m = train_step(state, batch, _step_draws(cfg, step))
        assert sorted(m) == sorted([*metrics[step], "grad_norm"])
        for k in metrics[step]:
            assert rel_err(m[k].numpy(), metrics[step][k]) <= 1e-5, (step, k)
        trained = [n for n, p in port.named_parameters() if p.requires_grad]
        assert trained and all(n.startswith("refiner.") for n in trained)
        if step == 0:
            jg = state_dict_from_jax({"params": grads["params"]})
            got_g = np.concatenate([dict(port.named_parameters())[n].grad.numpy().ravel() for n in trained])
            assert rel_err(got_g, np.concatenate([jg[n].numpy().ravel() for n in trained])) <= 1e-4
    before, after = state_dict_from_jax(params), state_dict_from_jax(after_params)
    sd = port.state_dict()
    d_port = np.concatenate([(sd[k] - before[k]).numpy().ravel() for k in trained])
    d_jax = np.concatenate([(after[k] - before[k]).numpy().ravel() for k in trained])
    assert np.abs(d_jax).max() > 0
    assert np.linalg.norm(d_port - d_jax) / np.linalg.norm(d_jax) <= 1e-4
    for k in sd:  # the frozen online model, on both sides
        if not k.startswith("refiner."):
            assert torch.equal(sd[k], before[k]) and torch.equal(after[k], before[k]), k
    assert np.array_equal(state.memory.count.numpy(), np.asarray(want_mem.count))
    assert int(state.memory.count.sum()) > 0
    filled = np.asarray(want_mem.embeds) != 0
    assert np.array_equal(state.memory.embeds.numpy() != 0, filled)
    assert rel_err(state.memory.embeds.numpy(), np.asarray(want_mem.embeds)) <= 1e-5
