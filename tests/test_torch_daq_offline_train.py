"""DVIS-DAQ offline training (the temporal refiner on the frozen segmenter
and cutter) against the JAX package on the same numpy inputs, with the JAX
draws answered to the port by site. The tiny DAQ of
``tests/test_torch_common.py`` (its cutter's class head x8, so that some
queries pass the selection thresholds and some do not), 3 frames of 64x96,
fp32, JV matchers, the 2 best of the 6 sequence rows refined
(``offline_topk_num=2``, so the top-K mask hides rows).

Bars: the training forward, the sequences' mean logits and masks and every
refiner layer's logits and masks rel <= 1e-5; one train step at B=1
against ``engine/trainer.py::build_train_step``: every loss of two steps
(matched on the cutter's outputs, then on the refiner's: ``max_iter`` 2)
rel <= 1e-5, the refiner's gradients rel <= 1e-4 as a norm, the update
after two steps within 1e-4 as a norm, the segmenter and cutter unchanged;
at B=2 the losses and gradients are the mean of the JAX step's over each
clip alone, the mask losses divided by the batch's mean instance count. Beside them, the JAX step at B=2: it hands the loss one clip's
outputs beside both clips' targets, and the matcher's ``vmap`` refuses the
mismatch."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dvis_plus_tpu.engine import trainer as jtrain
from dvis_plus_tpu.engine.trainer import Batch as JaxBatch
from dvis_plus_tpu.models.meta.daq import DAQOffline as JaxOffline
from dvis_plus_tpu_torch.cli import build_model
from dvis_plus_tpu_torch.convert import state_dict_from_jax
from dvis_plus_tpu_torch.engine import trainer as ptrain
from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step
from tests.test_torch_common import (
    H_IN,
    W_IN,
    JaxDraws,
    images,
    jax_daq_model_and_params,
    nchw,
    rel_err,
)
from tests.test_torch_daq_train import (
    batched,
    check_shared_batch,
    grads_by_divisor,
    jax_targets,
    port_targets,
)
from tests.test_torch_minvis_train import _capture
from tests.test_torch_offline_train import offline_loss_draws

torch.set_num_threads(2)
T, N = 3, 4


@functools.cache
def _setup():
    """(cfg, JAX DAQOffline, params): segmenter and cutter frozen, the 2
    best sequences refined, the matcher guided by the cutter's outputs for
    the first step only."""
    cfg, _, params, _ = jax_daq_model_and_params("daq_offline")
    cfg = copy.deepcopy(cfg)
    cfg.model.freeze = ("segmenter", "cutter")
    cfg.model.daq.offline_topk_num = 2
    cfg.solver.max_iter = 2
    cfg.solver.warmup_iters = 3
    cfg.solver.warmup_factor = 0.5
    return cfg, JaxOffline(cfg.model), params


def port_offline():
    cfg, _, params = _setup()
    pm = build_model(cfg.model)
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    return pm


def clip(seed, instances=N - 1):
    """3 frames and four instance slots at the stride-4 size: three
    instances (or ``instances``), the second absent from frame 0."""
    rng = np.random.RandomState(seed)
    h, w = H_IN // 4, W_IN // 4
    masks = np.zeros((N, T, h, w), bool)
    for n in range(instances):
        y, x = rng.randint(0, h - 6), rng.randint(0, w - 8)
        for t in range(T):
            if not (n == 1 and t == 0):
                masks[n, t, y:y + 5, x + t:x + t + 6] = True
    fv = masks.reshape(N, T, -1).any(-1)
    return images(T, seed=71 + seed), (rng.randint(0, 5, N).astype(np.int32), masks, fv.any(-1), fv)


def test_training_forward_matches_jax():
    cfg, jm, params = _setup()
    x, _ = clip(0)
    online, refine = jax.device_get(jax.jit(lambda p, im: jm.apply(p, im))(params, jnp.asarray(x)))
    with torch.no_grad():
        (pon, pref), = port_offline().train_forward(nchw(x)[None])
    valid = online["pred_logits"][0, 0].any(-1)
    assert 2 < valid.sum() and np.asarray(refine["pred_logits"]).shape[2] == cfg.model.daq.max_num_instances
    for k in ("pred_logits", "pred_masks"):
        assert rel_err(pon[k].numpy(), online[k]) <= 1e-5, k
        assert rel_err(pref[k].numpy(), refine[k]) <= 1e-5, k
        for i, (g, w) in enumerate(zip(pref["aux_" + k], refine["aux_" + k])):
            assert rel_err(g.numpy(), w) <= 1e-5, (k, i)


@functools.cache
def _jax_step_fn():
    cfg, jm, _ = _setup()
    return jtrain.build_train_step(cfg, jm, optimizer=optax.chain(_capture(), jtrain.build_optimizer(cfg)))


@functools.cache
def _jax_steps():
    cfg, _, params = _setup()
    x, tg = clip(1)
    step_fn, init_state = _jax_step_fn()
    state = init_state(jax.tree_util.tree_map(jnp.asarray, params))
    batch = JaxBatch(images=jnp.asarray(x)[None], targets=jax_targets(*batched(tg)))
    metrics, grads = [], []
    for _ in range(2):
        state, m = step_fn(state, batch, jax.random.key(cfg.seed))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
        grads.append(jax.tree_util.tree_map(np.asarray, state.opt_state[0]))
    return metrics, grads, jax.tree_util.tree_map(np.asarray, state.params)


def step_draws(cfg, key, step, clip_=0):
    """The loss's draws of the JAX step at ``step`` under ``key``, for the
    port's clip ``clip_``."""
    _, r2 = jax.random.split(jax.random.fold_in(key, step))
    table = offline_loss_draws(r2, 1, cfg.model.refiner.num_layers - 1, jtrain.criterion_config(cfg), T)
    return {("clip", clip_, *site): v for site, v in table.items()}


def test_train_step_matches_jax():
    cfg, _, params = _setup()
    metrics, grads, after = _jax_steps()
    x, tg = clip(1)
    pm = port_offline()
    train_step, init = build_train_step(cfg, pm)
    state = init()
    assert state.memory is None and pm.tracker.training is False and pm.refiner.training
    batch = Batch(nchw(x)[None], port_targets(*batched(tg)))
    for step in range(2):
        state, m = train_step(state, batch, JaxDraws(step_draws(cfg, jax.random.key(cfg.seed), step)))
        assert sorted(m) == sorted([*metrics[step], "grad_norm"]) and "loss_reid" not in m
        for k in metrics[step]:
            assert rel_err(m[k].numpy(), metrics[step][k]) <= 1e-5, (step, k)
        trained = [n for n, p in pm.named_parameters() if p.requires_grad]
        assert trained and all(n.startswith("refiner.") for n in trained)
        jg = state_dict_from_jax({"params": grads[step]["params"]})
        want_g = np.concatenate([jg[n].numpy().ravel() for n in trained])
        got_g = np.concatenate([dict(pm.named_parameters())[n].grad.numpy().ravel() for n in trained])
        assert np.linalg.norm(got_g - want_g) / np.linalg.norm(want_g) <= 1e-4, step
    before, want_after = state_dict_from_jax(params), state_dict_from_jax(after)
    got_after = pm.state_dict()
    for name in before:
        if not name.startswith("refiner."):
            assert torch.equal(got_after[name], before[name]), name
    names = [n for n in before if n.startswith("refiner.")]
    delta_w = np.concatenate([(want_after[n] - before[n]).numpy().ravel() for n in names])
    delta_g = np.concatenate([(got_after[n] - before[n]).numpy().ravel() for n in names])
    assert np.linalg.norm(delta_w) > 0
    assert np.linalg.norm(delta_g - delta_w) / np.linalg.norm(delta_w) <= 1e-4


def test_two_clips_give_the_mean_of_the_jax_clips():
    """B=2, clips of three and two instances, against the JAX step over
    each clip alone (``tests/test_torch_daq_train.py::check_shared_batch``:
    the mask losses divided by the batch's mean instance count)."""
    cfg, _, params = _setup()
    step_fn, init_state = _jax_step_fn()
    clips = [clip(2), clip(3, instances=2)]
    want, alone, table = [], [], {}
    for b, (x, tg) in enumerate(clips):
        key = jax.random.key(50 + b)
        state, m = step_fn(init_state(jax.tree_util.tree_map(jnp.asarray, params)),
                           JaxBatch(images=jnp.asarray(x)[None], targets=jax_targets(*batched(tg))), key)
        want.append({k: np.asarray(v) for k, v in m.items() if k not in ("total_loss", "grad_norm")})
        jg = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.opt_state[0])["params"])
        want_g = np.concatenate([jg[n].numpy().ravel() for n in sorted(jg) if n.startswith("refiner.")])
        table.update(step_draws(cfg, key, 0, b))
        # the port's step over this clip alone: its gradient is the JAX one
        pm = port_offline()
        ptrain.set_modes(pm)
        _, losses, _ = ptrain.build_loss_fn(cfg, pm)(
            Batch(nchw(x)[None], port_targets(*batched(tg))), JaxDraws(step_draws(cfg, key, 0)), 0, None)
        alone.append(grads_by_divisor(losses, [p for n, p in sorted(pm.named_parameters())
                                               if n.startswith("refiner.")]))
        got_g = sum(alone[-1].values())
        assert np.linalg.norm(got_g - want_g) / np.linalg.norm(want_g) <= 1e-4, b
    pm = port_offline()
    ptrain.set_modes(pm)
    batch = Batch(torch.stack([nchw(x) for x, _ in clips]), port_targets(*batched(*(t for _, t in clips))))
    check_shared_batch(ptrain.build_loss_fn(cfg, pm), batch, JaxDraws(table), 0, want, alone,
                       lambda: {"main": [int(t[2].sum()) for _, t in clips]},
                       [(n, p) for n, p in sorted(pm.named_parameters()) if n.startswith("refiner.")])


class _OneClipOutputs:
    """Stands in for the JAX DAQOffline: the outputs of one clip, as the JAX
    module gives for the first clip of the batch."""

    def apply(self, params, images, rng=None):
        rng = np.random.RandomState(0)
        S, K1, h, w = 6, 6, H_IN // 4, W_IN // 4
        layer = lambda: (rng.randn(1, T, S, K1).astype(np.float32),  # noqa: E731
                         rng.randn(1, S, T, h, w).astype(np.float32))
        (lg, mk), (alg, amk) = layer(), layer()
        return ({"pred_logits": rng.randn(1, 1, S, K1).astype(np.float32),
                 "pred_masks": rng.randn(1, S, T, h, w).astype(np.float32)},
                {"pred_logits": lg, "pred_masks": mk, "aux_pred_logits": [alg], "aux_pred_masks": [amk],
                 "pred_embds": rng.randn(1, T, S, 32).astype(np.float32)})


def test_jax_offline_step_refuses_two_clips():
    """The JAX DAQ offline loss takes the first clip's outputs and every
    clip's targets; at B=2 its clip matcher's vmap refuses the two batch
    sizes. The port trains each clip (above)."""
    cfg, _, _ = _setup()
    loss_fn = jtrain.build_loss_fn(cfg, _OneClipOutputs())
    clips = [clip(2), clip(3)]
    batch = JaxBatch(images=jnp.asarray(np.stack([x for x, _ in clips])),
                     targets=jax_targets(*batched(*(t for _, t in clips))))
    with pytest.raises(ValueError, match="vmap got inconsistent sizes"):
        loss_fn(None, batch, jax.random.key(0), 0, None)
