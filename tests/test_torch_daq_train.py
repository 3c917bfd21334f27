"""DVIS-DAQ online training (stages 2 and 3 of DVIS-DAQ: the cutter on the
frozen segmenter) against the JAX package on the same numpy inputs, with
the JAX draws answered to the port by site
(``tests/test_torch_common.py::JaxDraws``). The tiny DAQ of
``tests/test_torch_common.py`` (2 cutter layers, a table of 6 slots, 2
background slots, 8 new-instance queries), 3 frames of 64x96, fp32, JV
matchers.

Bars: ``frame_match`` and ``new_ins_match`` give the JAX assignments;
``daq_criterion`` and ``offline_topk_mask`` rel <= 1e-5; the cutter's
training forward in stages 2 and 3, every frame's and layer's logits and
masks rel <= 1e-5 with the same assignments, live rows and disappearances
(stage 3 simulating one). Beside them, the JAX step's two departures from
the reference that the port does not follow: it switches stage at
``daq.steps[0]`` (the port at ``increasing_step[0]``), and it trains the
first clip of its batch alone. Then the curriculum slice against the JAX
function, and a third departure: the JAX CLI cuts the offline stage's
clips too, the port (as the reference) leaves them whole. The train steps against the JAX ones run in
``tests/test_torch_daq_train_stage{2,3}.py`` with the helpers here."""
import copy
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dvis_plus_tpu.engine import trainer as jtrain
from dvis_plus_tpu.engine.trainer import Batch as JaxBatch
from dvis_plus_tpu.losses.criterion import CriterionConfig as JaxCriterionConfig
from dvis_plus_tpu.losses.matcher import MatchCosts as JaxCosts
from dvis_plus_tpu.losses.targets import VideoTargets as JaxTargets
from dvis_plus_tpu.models.daq import criterion as jcrit
from dvis_plus_tpu.models.daq import matcher as jmatch
from dvis_plus_tpu.models.meta import daq as jdaq
from dvis_plus_tpu_torch.convert import state_dict_from_jax
from dvis_plus_tpu_torch.engine import trainer as ptrain
from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step, criterion_config
from dvis_plus_tpu_torch.losses.criterion import CriterionConfig
from dvis_plus_tpu_torch.losses.matcher import MatchCosts
from dvis_plus_tpu_torch.losses.targets import VideoTargets
from dvis_plus_tpu_torch.models.daq import criterion as pcrit
from dvis_plus_tpu_torch.models.daq import matcher as pmatch
from dvis_plus_tpu_torch.models.meta import daq as pdaq
from tests.test_torch_common import (
    DAQ_FQ,
    DAQ_K,
    DAQ_NS,
    DAQ_QC,
    H_IN,
    W_IN,
    JaxDraws,
    images,
    jax_daq_model_and_params,
    jax_uniform,
    loss_points,
    nchw,
    rel_err,
)
from tests.test_torch_minvis_train import _capture

torch.set_num_threads(2)
T, N, K, FQ, QC, NS = 3, 6, DAQ_K, DAQ_FQ, DAQ_QC, DAQ_NS
P = 64  # the tiny configuration's train_num_points


def clip_targets(seed=0, shift=0):
    """Five instances in six slots over 3 frames at the stride-4 size:
    instance 1 leaves after frame 1, instance 3 enters at frame 1, the last
    slot padding."""
    rng = np.random.RandomState(seed)
    h, w = H_IN // 4, W_IN // 4
    masks = np.zeros((N, T, h, w), bool)
    for n in range(N - 1):
        y, x = rng.randint(0, h - 6), rng.randint(0, w - 8)
        for t in range(T):
            if (n == 1 and t == 2) or (n == 3 and t == 0):
                continue
            masks[n, t, y:y + 5, x + t + shift:x + t + shift + 6] = True
    fv = masks.reshape(N, T, -1).any(-1)
    labels = rng.randint(0, K, N).astype(np.int32)
    return labels, masks, fv.any(-1), fv


def jax_targets(labels, masks, valid, fv):
    return JaxTargets(labels=jnp.asarray(labels), masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                      frame_valid=jnp.asarray(fv))


def port_targets(labels, masks, valid, fv):
    return VideoTargets(torch.from_numpy(np.asarray(labels)).long(), torch.from_numpy(np.asarray(masks)),
                        torch.from_numpy(np.asarray(valid)), torch.from_numpy(np.asarray(fv)))


def batched(*clips):
    return tuple(np.stack(x) for x in zip(*clips))


@functools.cache
def _setup(switch=1):
    """(cfg, JAX DAQOnline, params): the tiny DAQ, its segmenter frozen,
    the curriculum's boundary and the stage switch both at step ``switch``
    (where the two packages' switches agree). The
    cutter's positional MLP is scaled x20 a layer: at the random weights'
    scale its embeds are of order 1e-2, and the new-instance queries (one
    learned embedding, told apart by them alone) would match their ground
    truths at costs equal to 1e-6, where rounding picks the assignment."""
    cfg, jm, params, _ = jax_daq_model_and_params("daq_online")
    params = copy.deepcopy(params)
    for layer in params["params"]["cutter"]["pos_embed"].values():
        layer["kernel"] = layer["kernel"] * 20.0
    cfg = copy.deepcopy(cfg)
    cfg.model.freeze = ("segmenter",)
    cfg.model.daq.steps = cfg.model.daq.increasing_step = (switch,)
    cfg.solver.max_iter = 100
    cfg.solver.warmup_iters = 3
    cfg.solver.warmup_factor = 0.5
    return cfg, jm, params


def port_daq(switch=1):
    """The port's model with the weights of :func:`_setup`."""
    from dvis_plus_tpu_torch.cli import build_model

    cfg, _, params = _setup(switch)
    pm = build_model(cfg.model)
    pm.load_state_dict(state_dict_from_jax(params), strict=True)
    return pm


def online_draws(r1, r2, cfg, clip=0, T_=T):
    """The JAX draws of ``DAQOnline.__call__(.., r1)`` and ``daq_train_loss(r2,
    ..)`` for clip ``clip``: the frame matchings' points from split(r1, T+1)[t];
    the cutter's key split(r1, T+1)[T] split into 3T, frame i's new-instance
    points from [3i] and its disappearance pick from [3i+1]; the main and the
    slot criterion's points from the two halves of split(r2), split into one
    key a (frame, layer)."""
    jcc = jtrain.criterion_config(cfg)
    L = cfg.model.tracker.num_layers
    c = ("clip", clip)
    table = {}
    rngs = jax.random.split(r1, T_ + 1)
    for t in range(T_):
        table[(*c, "frame_match", t)] = jax_uniform(rngs[t], (P, 2))
    crngs = jax.random.split(rngs[T_], 3 * T_)
    for i in range(1, T_):
        table[(*c, "new_ins_match", i)] = jax_uniform(crngs[3 * i], (P, 2))
        table[(*c, "disappear", i)] = np.asarray(jax.random.randint(crngs[3 * i + 1], (), 0, QC))
    ra, rb = jax.random.split(r2)
    for name, key, frames, layers, rows in (("main", ra, T_, L + 1, lambda i: FQ if i == 0 else QC + FQ),
                                            ("slot", rb, T_ - 1, L, lambda i: QC + NS)):
        keys = jax.random.split(key, frames * layers)
        for i in range(frames):
            for layer in range(layers):
                over, fill = loss_points(keys[i * layers + layer], rows(i), jcc)
                table[(*c, name, "points", i, layer, "over")] = over
                table[(*c, name, "points", i, layer, "fill")] = fill
    return table


# ---------------------------------------------------------------------------
# the matchers, the criterion, the top-K mask
# ---------------------------------------------------------------------------


def _frame(seed, S=12):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(S, K + 1) * 2).astype(np.float32)
    masks = (rng.randn(S, 16, 24) * 3).astype(np.float32)
    labels, tmasks, _, fv = clip_targets(seed)
    return logits, masks, labels, tmasks[:, 1], fv[:, 1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frame_match_matches_jax(seed):
    logits, masks, labels, tmasks, valid = _frame(seed)
    key = jax.random.key(seed)
    costs = JaxCosts(num_points=P, solver="jv")
    want = jax.jit(lambda *a: jmatch.frame_match(key, *a, select_thr=0.3, costs=costs))(
        logits, masks, labels, tmasks, valid)
    coords = torch.from_numpy(np.array(jax_uniform(key, (P, 2))))
    got = pmatch.frame_match(*(torch.from_numpy(np.asarray(a)) for a in (logits, masks, labels, tmasks,
                                                                         valid)),
                             coords, 0.3, MatchCosts(num_points=P))
    assert (got.tgt_for_query >= 0).sum() == valid.sum()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("tracked", [(-1,) * 12, (2, -1, 0, -1, -1, 4) + (-1,) * 6],
                         ids=["none-tracked", "three-tracked"])
def test_new_ins_match_matches_jax(tracked):
    logits, masks, labels, tmasks, valid = _frame(5)
    key = jax.random.key(9)
    costs = JaxCosts(num_points=P, solver="jv")
    t4t = np.asarray(tracked, np.int32)
    want = jax.jit(lambda *a: jmatch.new_ins_match(key, *a, num_new_ins=6, costs=costs))(
        logits, masks, labels, tmasks, valid, t4t)
    coords = torch.from_numpy(np.array(jax_uniform(key, (P, 2))))
    got = pmatch.new_ins_match(*(torch.from_numpy(np.asarray(a)) for a in (logits, masks, labels, tmasks,
                                                                           valid)),
                               torch.from_numpy(t4t).long(), 6, coords, MatchCosts(num_points=P))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    new = valid & ~np.isin(np.arange(N), t4t)
    assert sorted(got.numpy()[6:][got.numpy()[6:] >= 0]) == sorted(np.flatnonzero(new))


def _outputs(seed, L=3):
    """Three frames' cutter-like outputs (the first with 8 queries, then
    6 + 8) with assignments, dead rows and a disappearance."""
    rng = np.random.RandomState(seed)
    outs = []
    for i, S in enumerate((8, 14, 14)):
        t4q = np.full(S, -1, np.int32)
        t4q[rng.permutation(S)[:4]] = rng.permutation(N)[:4]
        alive = np.ones(S, bool)
        if i:
            alive[rng.permutation(6)[:2]] = False
        dis = np.zeros(N, bool)
        dis[rng.randint(N)] = i > 0
        outs.append({"pred_logits": (rng.randn(L, S, K + 1) * 2).astype(np.float32),
                     "pred_masks": (rng.randn(L, S, 16, 24) * 3).astype(np.float32),
                     "tgt_for_query": t4q, "query_alive": alive, "disappeared": dis})
    return outs


def test_daq_criterion_matches_jax():
    labels, masks, valid, fv = clip_targets(3)
    outs = _outputs(4)
    cfg = CriterionConfig(num_classes=K, num_points=P)
    jcfg = JaxCriterionConfig(num_classes=K, num_points=P)
    key = jax.random.key(5)
    want = jax.jit(lambda o, t: jcrit.daq_criterion(key, o, t, [0, 1, 2], jcfg))(
        outs, jax_targets(labels, masks, valid, fv))
    keys = jax.random.split(key, 3 * 3)
    table = {}
    for i, o in enumerate(outs):
        for layer in range(3):
            table[("points", i, layer, "over")], table[("points", i, layer, "fill")] = loss_points(
                keys[i * 3 + layer], o["tgt_for_query"].shape[0], jcfg)
    pouts = [{k: torch.from_numpy(v) for k, v in o.items()} for o in outs]
    for o in pouts:
        o["tgt_for_query"] = o["tgt_for_query"].long()
    got = pcrit.daq_criterion(pouts, port_targets(labels, masks, valid, fv), [0, 1, 2], cfg,
                              JaxDraws(table))
    assert sorted(got) == sorted(want) and "loss_dice_1" in got
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k


@pytest.mark.parametrize("topk", [2, 4, 20])
def test_offline_topk_mask_matches_jax(topk):
    rng = np.random.RandomState(topk)
    scores = rng.rand(10).astype(np.float32)
    scores[3] = scores[7]  # a tie at the boundary is kept on both sides
    alive = rng.rand(10) > 0.3
    want = jdaq.offline_topk_mask(jnp.asarray(scores), jnp.asarray(alive), topk)
    got = pdaq.offline_topk_mask(torch.from_numpy(scores), torch.from_numpy(alive), topk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the cutter's training forward
# ---------------------------------------------------------------------------


def _clip(seed=0):
    return images(T, seed=61 + seed), clip_targets(seed)


@functools.cache
def _forward(stage, seed):
    """(JAX outputs, slot outputs; the port's) of one clip in ``stage``."""
    cfg, jm, params = _setup()
    x, tg = _clip(seed)
    r1 = jax.random.key(100 + seed)
    outs, slots, _ = jax.jit(lambda p, im, t: jm.apply(p, im, t, r1, stage=stage))(
        params, jnp.asarray(x), jax_targets(*tg))
    pm = port_daq()
    with torch.no_grad():
        (pouts, pslots), = pm.train_forward(
            nchw(x)[None], port_targets(*batched(tg)), JaxDraws(online_draws(r1, r1, cfg)), stage,
            criterion_config(cfg).costs())
    return jax.device_get((outs, slots)), (pouts, pslots)


@pytest.mark.parametrize("stage", [2, 3])
def test_cutter_training_forward_matches_jax(stage):
    # clip 7 holds four tracked ground truths in stage 3, and one disappears
    (outs, slots), (pouts, pslots) = _forward(stage, 0 if stage == 2 else 7)
    assert len(pouts) == T and len(pslots) == T - 1
    for name, want, got in (("main", outs, pouts), ("slot", slots, pslots)):
        for i, (w, g) in enumerate(zip(want, got)):
            for k in ("tgt_for_query", "query_alive", "disappeared"):
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=f"{name} {i} {k}")
            for k in ("pred_logits", "pred_masks"):
                assert g[k].shape == w[k].shape
                for layer in range(w[k].shape[0]):
                    assert rel_err(g[k][layer].numpy(), w[k][layer]) <= 1e-5, (name, i, k, layer)
    tracked = [int((np.asarray(o["tgt_for_query"]) >= 0).sum()) for o in outs]
    assert min(tracked) > 0, tracked
    if stage == 3:
        # the slot branch was shown a disappearance the main branch was not
        assert any((np.asarray(s["disappeared"]) != np.asarray(o["disappeared"])).any()
                   for s, o in zip(slots, outs[1:]))


# ---------------------------------------------------------------------------
# the train step (run by tests/test_torch_daq_train_stage{2,3}.py, one JAX
# executable each)
# ---------------------------------------------------------------------------


@functools.cache
def _jax_step_fn(switch):
    """The JAX train step with the package's optimizer, a first stage
    keeping the raw gradients."""
    cfg, jm, _ = _setup(switch)
    return jtrain.build_train_step(cfg, jm, optimizer=optax.chain(_capture(), jtrain.build_optimizer(cfg)))


@functools.cache
def _jax_steps(switch):
    """Two JAX train steps at B=1."""
    cfg, jm, params = _setup(switch)
    x, tg = _clip(2)
    jbatch = JaxBatch(images=jnp.asarray(x)[None], targets=jax_targets(*batched(tg)))
    step_fn, init_state = _jax_step_fn(switch)
    state = init_state(jax.tree_util.tree_map(jnp.asarray, params))
    metrics, grads = [], []
    for step in range(2):
        state, m = step_fn(state, jbatch, jax.random.key(cfg.seed))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
        grads.append(jax.tree_util.tree_map(np.asarray, state.opt_state[0]))
    return metrics, grads, jax.tree_util.tree_map(np.asarray, state.params)


def step_draws(cfg, step, clip=0):
    """fold the step into key(seed), split: the model's key and the loss's."""
    r1, r2 = jax.random.split(jax.random.fold_in(jax.random.key(cfg.seed), step))
    return online_draws(r1, r2, cfg, clip)


def check_two_steps(switch, stages):
    """Two port train steps at B=1 against the JAX ones (in ``stages``):
    the losses, the cutter's gradients, the update after both, the
    segmenter unchanged."""
    cfg, _, params = _setup(switch)
    metrics, grads, after = _jax_steps(switch)
    x, tg = _clip(2)
    pm = port_daq(switch)
    train_step, init = build_train_step(cfg, pm)
    state = init()
    batch = Batch(nchw(x)[None], port_targets(*batched(tg)))
    assert not pm.sem_seg_head.training and pm.tracker.training
    for step in range(2):
        assert ptrain.daq_stage(cfg, step) == stages[step]
        state, m = train_step(state, batch, JaxDraws(step_draws(cfg, step)))
        assert sorted(m) == sorted([*metrics[step], "grad_norm"])
        assert "slot_loss_ce" in m and "loss_dice_0" in m and "slot_loss_mask_0" in m
        for k in metrics[step]:
            assert rel_err(m[k].numpy(), metrics[step][k]) <= 1e-5, (step, k)
        trained = [n for n, p in pm.named_parameters() if p.requires_grad]
        assert trained and all(n.startswith("tracker.") for n in trained)
        jg = state_dict_from_jax({"params": grads[step]["params"]})
        want_g = np.concatenate([jg[n].numpy().ravel() for n in trained])
        got_g = np.concatenate([dict(pm.named_parameters())[n].grad.numpy().ravel() for n in trained])
        assert np.linalg.norm(got_g - want_g) / np.linalg.norm(want_g) <= 1e-4, step
    before, want_after = state_dict_from_jax(params), state_dict_from_jax(after)
    got_after = pm.state_dict()
    for name in before:
        if name.startswith(("backbone.", "sem_seg_head.")):
            assert torch.equal(got_after[name], before[name]), name
    names = [n for n in before if n.startswith("tracker.")]
    delta_w = np.concatenate([(want_after[n] - before[n]).numpy().ravel() for n in names])
    delta_g = np.concatenate([(got_after[n] - before[n]).numpy().ravel() for n in names])
    assert np.linalg.norm(delta_w) > 0
    assert np.linalg.norm(delta_g - delta_w) / np.linalg.norm(delta_w) <= 1e-4


def divisor_group(key):
    """What a loss ``key`` is divided by: None for the class losses (their
    own weights), "main" or "slot" for the mask and dice losses (the matched
    count of that branch)."""
    if "mask" not in key and "dice" not in key:
        return None
    return "slot" if key.startswith("slot_") else "main"


def grads_by_divisor(losses, params):
    """The flat gradient of the sum of each :func:`divisor_group`'s losses."""
    out = {}
    for group in {divisor_group(k) for k in losses}:
        total = sum(v for k, v in losses.items() if divisor_group(k) == group)
        got = torch.autograd.grad(total, params, retain_graph=True, allow_unused=True)
        out[group] = np.concatenate([(torch.zeros_like(p) if g is None else g).numpy().ravel()
                                     for p, g in zip(params, got)])
    return out


def shared_factors(counts):
    """Per clip, its own count over the batch's mean count (each at least
    1): what takes a clip's mask losses from the divisor the JAX step gives
    it alone to the one a batch shares (the reference's count, all-reduced
    over its one-clip GPUs and divided by their number)."""
    n = np.asarray(counts, float)
    return np.maximum(n, 1.0) / max(n.mean(), 1.0)


def check_shared_batch(loss_fn, batch, draws, step, want, alone, counts, trained):
    """A port step over a batch of clips against the JAX step over each clip
    alone: every loss is the mean over the clips of the JAX clip's, its mask
    losses scaled by :func:`shared_factors` (1e-5); the clips' counts
    differ, so that the divisor shows. The gradient is the mean over the
    clips of their losses' gradients so scaled (1e-4 as a norm): ``alone``
    holds each clip's gradients by :func:`grads_by_divisor` from the port's
    step over that clip alone, whose sum the caller held against the JAX
    gradient. ``counts``: the batch's forward -> the counts by group."""
    total, losses, _ = loss_fn(batch, draws, step, None)
    n = counts()
    assert all(len(set(c)) == len(c) for c in n.values()), n
    for k in losses:
        f = np.ones(len(want)) if divisor_group(k) is None else shared_factors(n[divisor_group(k)])
        assert rel_err(losses[k].detach().numpy(), sum(w[k] * fb for w, fb in zip(want, f)) / len(want)) \
            <= 1e-5, k
    total.backward()
    got_g = np.concatenate([p.grad.numpy().ravel() for _, p in trained])
    mean_g = sum(g * (1.0 if group is None else shared_factors(n[group])[b])
                 for b, clip_g in enumerate(alone) for group, g in clip_g.items()) / len(alone)
    assert np.linalg.norm(got_g - mean_g) / np.linalg.norm(mean_g) <= 1e-4


def matched_counts(per_clip):
    """The clips' matched live queries over every frame, by branch."""
    def count(outs):
        return [int(sum(((o["tgt_for_query"] >= 0) & o["query_alive"]).sum() for o in c)) for c in outs]
    return {"main": count([o for o, _ in per_clip]), "slot": count([s for _, s in per_clip])}


def recording_forward(model, log):
    """Record what the model's training forward returns into ``log``."""
    forward = model.train_forward

    def recording(*args, **kw):
        log.append(forward(*args, **kw))
        return log[-1]

    model.train_forward = recording


def check_two_clips(switch):
    """B=2 against the JAX step over each clip alone (:func:`check_shared_batch`):
    the reference's one clip a GPU under DDP, its criterion's count
    all-reduced. The JAX executable of :func:`_jax_steps` serves, in the
    stage its host counter has reached after those two steps."""
    cfg, _, params = _setup(switch)
    _jax_steps(switch)
    step_fn, init_state = _jax_step_fn(switch)
    clips = [_clip(3), _clip(4)]
    want, alone, table = [], [], {}
    for b, (x, tg) in enumerate(clips):
        state, m = step_fn(init_state(jax.tree_util.tree_map(jnp.asarray, params)),
                           JaxBatch(images=jnp.asarray(x)[None], targets=jax_targets(*batched(tg))),
                           jax.random.key(40 + b))
        want.append({k: np.asarray(v) for k, v in m.items() if k not in ("total_loss", "grad_norm")})
        jg = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.opt_state[0])["params"])
        want_g = np.concatenate([jg[n].numpy().ravel() for n in sorted(jg) if n.startswith("tracker.")])
        r1, r2 = jax.random.split(jax.random.fold_in(jax.random.key(40 + b), 0))
        table.update(online_draws(r1, r2, cfg, clip=b))
        # the port's step over this clip alone: its gradient is the JAX one
        pm = port_daq(switch)
        ptrain.set_modes(pm)
        _, losses, _ = ptrain.build_loss_fn(cfg, pm)(
            Batch(nchw(x)[None], port_targets(*batched(tg))), JaxDraws(online_draws(r1, r2, cfg)), 2, None)
        trained = [p for n, p in sorted(pm.named_parameters()) if n.startswith("tracker.")]
        alone.append(grads_by_divisor(losses, trained))
        got_g = sum(alone[-1].values())
        assert np.linalg.norm(got_g - want_g) / np.linalg.norm(want_g) <= 1e-4, b
    pm, log = port_daq(switch), []
    ptrain.set_modes(pm)
    recording_forward(pm, log)
    batch = Batch(torch.stack([nchw(x) for x, _ in clips]), port_targets(*batched(*(t for _, t in clips))))
    check_shared_batch(ptrain.build_loss_fn(cfg, pm), batch, JaxDraws(table), 2, want, alone,
                       lambda: matched_counts(log[0]),
                       [(n, p) for n, p in sorted(pm.named_parameters()) if n.startswith("tracker.")])


class _Spy:
    """Stands in for the JAX model in ``build_loss_fn``: records what each
    training forward is given, then stops the step."""

    class Stop(Exception):
        pass

    def __init__(self):
        self.calls = []

    def apply(self, params, images, targets, rng, stage=2):
        self.calls.append((tuple(images.shape), stage))
        raise self.Stop


def test_jax_step_switches_stage_at_steps_not_increasing_step():
    """The JAX step enters stage 3 at ``daq.steps[0]`` (the curriculum's
    boundary) whatever ``increasing_step`` says; the port at
    ``increasing_step[0]``, the reference's switch."""
    cfg, _, params = _setup()
    cfg = copy.deepcopy(cfg)
    cfg.model.daq.steps, cfg.model.daq.increasing_step = (1,), (3,)
    spy = _Spy()
    step_fn, init_state = jtrain.build_train_step(cfg, spy, optimizer=optax.sgd(0.0))
    state = init_state({"params": {}})
    x, tg = _clip(0)
    batch = JaxBatch(images=jnp.asarray(x)[None], targets=jax_targets(*batched(tg)))
    for _ in range(4):
        with pytest.raises(_Spy.Stop):
            step_fn(state, batch, jax.random.key(0))
    assert [s for _, s in spy.calls] == [2, 3, 3, 3]
    assert [ptrain.daq_stage(cfg, s) for s in range(4)] == [2, 2, 2, 3]


def test_jax_step_trains_the_first_clip_alone():
    """The JAX DAQ loss hands its model the batch's first clip and nothing
    else; the port's trains every clip (above)."""
    cfg, _, _ = _setup()
    spy = _Spy()
    loss_fn = jtrain.build_loss_fn(cfg, spy)
    clips = [_clip(3), _clip(4)]
    batch = JaxBatch(images=jnp.asarray(np.stack([x for x, _ in clips])),
                     targets=jax_targets(*batched(*(t for _, t in clips))))
    with pytest.raises(_Spy.Stop):
        loss_fn(None, batch, jax.random.key(0), 0, None)
    assert spy.calls == [((T, H_IN, W_IN, 3), 2)]


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


def _raw_batch():
    """A collated batch of 2 clips of 7 frames (numpy)."""
    rng = np.random.RandomState(0)
    return {"images": rng.randn(2, 7, 4, 6, 3).astype(np.float32),
            "masks": rng.rand(2, 3, 7, 4, 6) > 0.5, "frame_valid": rng.rand(2, 3, 7) > 0.3,
            "valid": np.ones((2, 3), bool), "labels": np.zeros((2, 3), np.int32)}


@pytest.mark.parametrize("steps,ufn", [((5,), (3, 5)), ((2,), (2, 5)), ((), (3,))],
                         ids=["3-then-5", "2-then-5", "one-length"])
def test_curriculum_slice_matches_jax(steps, ufn):
    cfg, _, _ = _setup()
    cfg = copy.deepcopy(cfg)
    cfg.model.daq.steps, cfg.model.daq.using_frame_num = steps, ufn
    cfg.input.sampling_frame_num = 7
    cfg.solver.max_iter = 4
    raw = _raw_batch()
    jr, pr = random.Random(cfg.seed + 17), ptrain.curriculum_rng(cfg)
    for step in range(8):
        want = jtrain.daq_curriculum_slice(cfg, step, raw, jr)
        got = ptrain.daq_curriculum_slice(cfg, step, raw, pr)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{step} {k}")
        # a generator taken up at the next step draws on as this one does
        assert ptrain.curriculum_rng(cfg, step + 1).getstate() == pr.getstate()


def test_offline_stage_takes_the_whole_clip():
    """The reference's curriculum is in ``DVIS_DAQ_online.forward``
    (:241-279, SURVEY.md §3.6); its offline stage trains on every sampled
    frame. The JAX CLI cuts ``daq_offline`` clips too (its hook takes every
    ``daq*`` architecture, ``train_net_video.py:148``); the port's slice
    leaves them whole and draws nothing."""
    cfg, _, _ = _setup()
    cfg = copy.deepcopy(cfg)
    cfg.model.meta_architecture = "daq_offline"
    cfg.model.daq.steps, cfg.model.daq.using_frame_num = (5,), (3, 5)
    cfg.input.sampling_frame_num = 7
    raw = _raw_batch()
    assert jtrain.daq_curriculum_slice(cfg, 0, raw, random.Random(cfg.seed + 17))["images"].shape[1] == 3
    pr = ptrain.curriculum_rng(cfg, 3)
    for step in (0, 3, 10):
        assert ptrain.curriculum_frames(cfg, step) == 0
        assert ptrain.daq_curriculum_slice(cfg, step, raw, pr) is raw
    assert pr.getstate() == random.Random(cfg.seed + 17).getstate()
