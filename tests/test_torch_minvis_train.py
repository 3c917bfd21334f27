"""MinVIS and CTVIS training (stage 1 of the DVIS++ recipe) against the JAX
package on the same numpy inputs, with the JAX draws answered to the port by
site (``tests/test_torch_common.py::JaxDraws``).

Bars: ``frame_fold_targets`` equal; ``minvis_train_loss`` every key rel <=
1e-5; ``_sgff_scan`` rel <= 1e-6; ``ctvis_reid_loss`` rel <= 1e-5 and its
gradient rel <= 1e-4; one MinVIS and one CTVIS train step against
``engine/trainer.py::build_train_step`` from the same weights and batch:
every loss of two steps rel <= 1e-5, the decoders' gradients rel <= 1e-4,
the backbone's within 5e-3 as a norm, the update after two steps (the
backbone frozen) within 2e-3 of the JAX one as a norm; and the same step
with every ReLU of both packages made smooth (``_relus``): the whole
segmenter's gradients rel <= 1e-4 and the two-step update within 1e-4 as a
norm. fp32, exact deformable op, JV matchers, the loss weights x100 (as
``tests/test_torch_train.py``: the random model's queries cost nearly the
same, and the JAX JV solves in fp32 beside pad costs of 1e6).

Why the ReLU step's bars are looser: the random R50's ReLU inputs reach
some 60 in res4, and where one lies within fp32 rounding of 0 (one of
res4's third block at -1.3e-4 in this batch) the two packages pass or stop
its gradient differently; that moves the weight gradient of one channel by
2 % of its largest and every earlier layer's by about 1e-3 (measured: 1.6e-3
as a norm here, 3e-4 to 1.3e-3 over five other batches; the decoders, which
no backbone kink reaches, agree to 6e-7). So the two-step update is held
with the backbone frozen on both sides (its gradients out of the clip's
norm). The pixel decoder's FPN has ReLUs too, and the second step's
gradients meet the same kinks there: the update after two steps is 7.2e-5
from the JAX one for MinVIS and 9.6e-4 for CTVIS (its largest gaps in the
FPN's convolutions), hence 2e-3. With the ReLUs smooth, measured on this
batch: the whole segmenter's gradients 4.0e-5 of their largest for both
(2.8e-4 and 3.0e-4 with ReLUs), the backbone's 4.3e-4 as a norm (1.5e-3
with ReLUs; what is left is not traced), and the two-step update 3.3e-5
for MinVIS and 2.3e-5 for CTVIS: the kinks account for CTVIS's 9.6e-4.

The JAX ResNet holds its FrozenBN statistics as ordinary parameters, frozen
only by an optimizer mask that ``model.freeze`` does not name for MinVIS and
CTVIS: its default optimizer moves them
(:func:`test_jax_default_optimizer_moves_frozen_bn_the_port_does_not`); the
port keeps them as buffers, as the reference's ``FrozenBatchNorm2d``. So the
JAX step is built with an optimizer that zeroes those leaves' gradients
before the clip and freezes them.
"""
import contextlib
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
from dvis_plus_tpu.engine.trainer import build_optimizer as jax_build_optimizer
from dvis_plus_tpu.engine.trainer import build_train_step as jax_build_train_step
from dvis_plus_tpu.engine.trainer import criterion_config as jax_criterion_config
from dvis_plus_tpu.losses.ctvis import _sgff_scan as jax_sgff_scan
from dvis_plus_tpu.losses.ctvis import ctvis_reid_loss as jax_ctvis_reid_loss
from dvis_plus_tpu.losses.targets import VideoTargets as JaxTargets
from dvis_plus_tpu.models.meta import minvis as jminvis
from dvis_plus_tpu_torch.convert import state_dict_from_jax
from dvis_plus_tpu_torch.engine.trainer import Batch, build_train_step
from dvis_plus_tpu_torch.losses.ctvis import ctvis_reid_loss, sgff_scan
from dvis_plus_tpu_torch.losses.targets import VideoTargets
from dvis_plus_tpu_torch.models.meta import minvis as pminvis
from tests.test_torch_common import (
    H_IN,
    W_IN,
    JaxDraws,
    add_points,
    clip_match_coords,
    images,
    jax_minvis_model_and_params,
    jax_uniform,
    nchw,
    port_arch_model,
    rel_err,
)

torch.set_num_threads(2)
T, BATCH, N = 3, 2, 4


def _batch(seed=3):
    """Two clips of three frames at 64x96, targets at the stride-4 size:
    three instances a clip, the second absent from frame 0, the fourth slot
    padding."""
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
    x = np.stack([images(T, seed=41 + b) for b in range(BATCH)])
    return x, labels, masks, fv.any(-1), fv


def _targets(labels, masks, valid, fv):
    return (JaxTargets(labels=jnp.asarray(labels), masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                       frame_valid=jnp.asarray(fv)),
            VideoTargets(torch.from_numpy(labels).long(), torch.from_numpy(masks),
                         torch.from_numpy(valid), torch.from_numpy(fv)))


def _cfg(arch):
    cfg, model, params = jax_minvis_model_and_params(arch)
    cfg = copy.deepcopy(cfg)  # the cached config stays as it is
    c = cfg.model.criterion
    c.train_num_points, c.class_weight, c.mask_weight, c.dice_weight = 200, 200.0, 500.0, 500.0
    cfg.solver.max_iter = 100
    cfg.solver.warmup_iters = 3
    cfg.solver.warmup_factor = 0.5
    return cfg, model, params


def criterion_draws(key, BT, n_aux, ccfg, P):
    """``video_criterion(key, ...)``'s draws with clip matching: split into
    2 (n_aux + 1) keys, the final layer's match and points first, then each
    auxiliary layer's."""
    keys = jax.random.split(key, 2 * (n_aux + 1))
    table = {("match", "final"): clip_match_coords(keys[0], BT, P)}
    add_points(table, "final", keys[1], BT * N, ccfg)
    for i in range(n_aux):
        table[("match", i)] = clip_match_coords(keys[2 + 2 * i], BT, P)
        add_points(table, i, keys[3 + 2 * i], BT * N, ccfg)
    return table


def ctvis_momentum_draws(key, B, T_, N_):
    """``ctvis_reid_loss(key, ...)``'s coins: video b, frame t draws from
    split(split(key, B)[b], T)[t]."""
    per_video = [[jax_uniform(kt, (N_,)) for kt in jax.random.split(kb, T_)]
                 for kb in jax.random.split(key, B)]
    return {("ctvis", "momentum", t): np.stack([v[t] for v in per_video]) for t in range(1, T_)}


def step_draws(cfg, step, arch):
    """The JAX step's draws: fold the step into key(seed), split in three:
    the criterion's, CTVIS's per-frame matching, CTVIS's coins."""
    r1, r2, r3 = jax.random.split(jax.random.fold_in(jax.random.key(cfg.seed), step), 3)
    ccfg = jax_criterion_config(cfg)
    BT = BATCH * T
    table = criterion_draws(r1, BT, cfg.model.transformer_decoder.dec_layers, ccfg, ccfg.num_points)
    if arch == "ctvis":
        table[("ctvis", "match")] = clip_match_coords(r2, BT, ccfg.num_points)
        table.update(ctvis_momentum_draws(r3, BATCH, T, N))
    return JaxDraws(table)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_frame_fold_targets_equal_jax():
    jt, pt = _targets(*_batch()[1:])
    want = jminvis.frame_fold_targets(jt)
    got = pminvis.frame_fold_targets(pt)
    for name in ("labels", "masks", "valid", "frame_valid"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.shape == w.shape and np.array_equal(g.numpy(), w), name


def test_minvis_train_loss_matches_jax():
    """Random per-frame decoder outputs (frames folded into the batch), the
    final and two auxiliary predictions."""
    cfg, _, _ = _cfg("minvis")
    ccfg = jax_criterion_config(cfg)
    jt, pt = _targets(*_batch(seed=5)[1:])
    rng = np.random.RandomState(9)
    Q, K, BT, h, w = 8, 5, BATCH * T, H_IN // 4, W_IN // 4
    lg = [rng.randn(BT, Q, K + 1).astype(np.float32) * 2 for _ in range(3)]
    mk = [rng.randn(BT, Q, h, w).astype(np.float32) * 3 for _ in range(3)]
    key = jax.random.key(11)
    want = jax.jit(lambda d, t: jminvis.minvis_train_loss(key, d, t, ccfg))(
        {"pred_logits": lg[2], "pred_masks": mk[2], "aux_pred_logits": lg[:2],
         "aux_pred_masks": mk[:2]}, jt)
    from dvis_plus_tpu_torch.engine.trainer import criterion_config

    got = pminvis.minvis_train_loss(
        {"pred_logits": torch.from_numpy(lg[2]), "pred_masks": torch.from_numpy(mk[2]),
         "aux_pred_logits": [torch.from_numpy(x) for x in lg[:2]],
         "aux_pred_masks": [torch.from_numpy(x) for x in mk[:2]]},
        pt, criterion_config(cfg), JaxDraws(criterion_draws(key, BT, 2, ccfg, ccfg.num_points)))
    assert sorted(got) == sorted(want) and len(got) == 9
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k


def test_sgff_scan_matches_jax():
    rng = np.random.RandomState(2)
    e = rng.randn(5, 4, 6, 12).astype(np.float32)
    v = rng.rand(5, 4, 6) > 0.3
    v[0, 0] = False  # an instance never seen
    want = np.stack([np.stack([np.asarray(jax_sgff_scan(jnp.asarray(e[i, n]), jnp.asarray(v[i, n])))
                               for n in range(4)]) for i in range(5)])
    got = sgff_scan(torch.from_numpy(e), torch.from_numpy(v)).numpy()
    assert rel_err(got, want) <= 1e-6


def test_ctvis_reid_loss_matches_jax_with_grads():
    """Q = 10 slots and 7 negatives (fewer than Q - 1), an instance seen
    only late, one never seen, one with a gap, and the padding slot."""
    rng = np.random.RandomState(4)
    B, T_, Q, C, N_ = 2, 4, 10, 12, 5
    embeds = rng.randn(B, T_, Q, C).astype(np.float32)
    q4g = np.stack([np.stack([rng.permutation(Q)[:N_] for _ in range(T_)]) for _ in range(B)]).astype(np.int32)
    fv = rng.rand(B, N_, T_) > 0.25
    fv[0, 1] = [False, False, True, True]
    fv[0, 2] = False
    fv[1, 3] = [True, False, False, True]
    key = jax.random.key(21)

    def f(e):
        out = jax_ctvis_reid_loss(key, e, jnp.asarray(q4g), jnp.asarray(fv), num_negatives=7)
        return out["loss_reid"], out["loss_aux_reid"]

    draws = JaxDraws(ctvis_momentum_draws(key, B, T_, N_))
    for i, name in enumerate(("loss_reid", "loss_aux_reid")):
        want = np.asarray(jax.jit(f)(jnp.asarray(embeds))[i])
        want_g = np.asarray(jax.jit(jax.grad(lambda e: f(e)[i]))(jnp.asarray(embeds)))
        e = torch.from_numpy(embeds).requires_grad_()
        got = ctvis_reid_loss(e, torch.from_numpy(q4g).long(), torch.from_numpy(fv), draws,
                              num_negatives=7)[name]
        assert rel_err(got.detach().numpy(), want) <= 1e-5, name
        got.backward()
        assert np.abs(want_g).max() > 0
        assert rel_err(e.grad.numpy(), want_g) <= 1e-4, name


# ---------------------------------------------------------------------------
# one train step, and the FrozenBN statistics
# ---------------------------------------------------------------------------


def _frozen_bn(path: str) -> bool:
    """The JAX ResNet's FrozenBN leaves (``scale``, ``bias``, ``mean``,
    ``var`` of a ``*norm*`` module under ``backbone``)."""
    parts = path.split("/")
    return "backbone" in parts and "norm" in parts[-2]


def _capture():
    """An optax stage that passes the updates on and keeps them as its
    state: put first, it holds the step's raw gradients."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda u, s, p=None: (u, u))


def _jax_optimizer(cfg, frozen):
    """The JAX optimizer of ``cfg`` with the leaves ``frozen(path)`` names
    frozen: their gradients zeroed before the clip, their updates masked;
    a first stage keeps the raw gradients."""
    s = cfg.solver
    sched = jopt.warmup_multistep_schedule(s.base_lr, s.steps, s.gamma, s.warmup_iters, s.warmup_factor)
    base = jopt.make_frozen_predicate(cfg.model.freeze)

    def mask(params):
        return jax.tree_util.tree_map_with_path(lambda path, x: frozen(jopt._path_str(path)), params)

    return optax.chain(_capture(), optax.masked(optax.set_to_zero(), mask), jopt.make_optimizer(
        sched, weight_decay=s.weight_decay, backbone_multiplier=s.backbone_multiplier,
        clip_value=s.clip_gradients_value, frozen_predicate=lambda p: base(p) or frozen(p)))


def _torch_batch():
    x, labels, masks, valid, fv = _batch()
    return Batch(torch.stack([nchw(v) for v in x]), _targets(labels, masks, valid, fv)[1])


@contextlib.contextmanager
def _relus(smooth):
    """With ``smooth``, every ReLU of both packages' segmenters
    (``flax.linen.relu``, ``torch.nn.functional.relu``, looked up at each
    call) is softplus(4x)/4 inside the block: the same function with no
    kink."""
    if not smooth:
        yield
        return
    import flax.linen as fnn

    old = fnn.relu, torch.nn.functional.relu
    fnn.relu = lambda x: jnp.logaddexp(4 * x, 0.0) / 4
    torch.nn.functional.relu = lambda x, inplace=False: torch.logaddexp(4 * x, x.new_zeros(())) / 4
    try:
        yield
    finally:
        fnn.relu, torch.nn.functional.relu = old


@functools.cache
def _jax_steps(arch, smooth=False):
    """Two JAX train steps with the backbone (FrozenBN included) frozen:
    (each step's losses, step 0's raw gradients of the whole model, the
    parameters before and after)."""
    cfg, model, params = _cfg(arch)
    x, labels, masks, valid, fv = _batch()
    jbatch = JaxBatch(images=jnp.asarray(x), targets=_targets(labels, masks, valid, fv)[0])
    step_fn, init_state = jax_build_train_step(
        cfg, model, optimizer=_jax_optimizer(cfg, lambda p: "backbone" in p.split("/")))
    state = init_state(jax.tree_util.tree_map(jnp.asarray, params))
    metrics, grads = [], None
    with _relus(smooth):
        for step in range(2):
            state, m = step_fn(state, jbatch, jax.random.key(cfg.seed))
            metrics.append({k: np.asarray(v) for k, v in m.items()})
            if step == 0:
                grads = jax.tree_util.tree_map(np.asarray, state.opt_state[0])
    return metrics, grads, params, jax.tree_util.tree_map(np.asarray, state.params)


@functools.cache
def _port_full_step(arch, smooth=False):
    """One port train step with the whole segmenter trained: (its metrics,
    its gradients, its buffers before and after)."""
    cfg, _, params = _cfg(arch)
    port = port_arch_model(cfg, params).train()
    buffers = {k: v.clone() for k, v in port.named_buffers()}
    train_step, init = build_train_step(cfg, port)
    with _relus(smooth):
        _, m = train_step(init(), _torch_batch(), step_draws(cfg, 0, arch))
    assert all(p.requires_grad for p in port.parameters())
    grads = {n: p.grad.numpy().copy() for n, p in port.named_parameters()}
    return m, grads, buffers, {k: v.clone() for k, v in port.named_buffers()}


def _port_two_steps(arch, smooth=False):
    """Two port train steps with the backbone frozen: (each step's metrics,
    the model after)."""
    cfg, _, params = _cfg(arch)
    cfg.model.freeze = ("backbone",)
    port = port_arch_model(cfg, params).train()
    train_step, init = build_train_step(cfg, port)
    state, batch, metrics = init(), _torch_batch(), []
    with _relus(smooth):
        for step in range(2):
            state, m = train_step(state, batch, step_draws(cfg, step, arch))
            metrics.append(m)
    return metrics, port


def _update_gap(params, after_params, port):
    """The port's update after two steps against the JAX one, as a norm
    over the decoders' parameters; the backbone stays as it was on both
    sides."""
    before, after = state_dict_from_jax(params), state_dict_from_jax(after_params)
    sd = port.state_dict()
    heads = [k for k, _ in port.named_parameters() if k.startswith("sem_seg_head.")]
    d_port = np.concatenate([(sd[k] - before[k]).numpy().ravel() for k in heads])
    d_jax = np.concatenate([(after[k] - before[k]).numpy().ravel() for k in heads])
    assert np.abs(d_jax).max() > 0
    for k in sd:
        if k.startswith("backbone."):
            assert torch.equal(sd[k], before[k]) and torch.equal(after[k], before[k]), k
    return np.linalg.norm(d_port - d_jax) / np.linalg.norm(d_jax)


def _flat(tree, names):
    return np.concatenate([np.asarray(tree[n]).ravel() for n in names])


@pytest.mark.parametrize("arch", ["minvis", "ctvis"])
def test_train_step_matches_jax(arch):
    cfg, _, _ = _cfg(arch)
    metrics, grads, params, after_params = _jax_steps(arch)
    jg = state_dict_from_jax({"params": grads["params"]})
    m, got_g, _, _ = _port_full_step(arch)
    want = metrics[0]
    assert sorted(m) == sorted([*want, "grad_norm"]) and ("loss_reid" in m) == (arch == "ctvis")
    for k in want:
        assert rel_err(m[k].numpy(), want[k]) <= 1e-5, k
    heads = [n for n in got_g if n.startswith("sem_seg_head.")]
    backbone = [n for n in got_g if n.startswith("backbone.")]
    assert heads and backbone and len(heads) + len(backbone) == len(got_g)
    assert rel_err(_flat(got_g, heads), _flat(jg, heads)) <= 1e-4
    gb, wb = _flat(got_g, backbone), _flat(jg, backbone)
    assert np.linalg.norm(gb - wb) / np.linalg.norm(wb) <= 5e-3

    # two steps with the backbone frozen on both sides
    got, port = _port_two_steps(arch)
    for step in range(2):
        for k in metrics[step]:
            assert rel_err(got[step][k].numpy(), metrics[step][k]) <= 1e-5, (step, k)
    assert _update_gap(params, after_params, port) <= 2e-3


@pytest.mark.parametrize("arch", ["minvis", "ctvis"])
def test_train_step_matches_jax_without_relu_kinks(arch):
    """The same step with every ReLU of both packages smooth (``_relus``):
    no ReLU input near a kink, so the whole segmenter's gradients, the
    backbone's too, within 1e-4, and the update after two steps within 1e-4
    as a norm."""
    metrics, grads, params, after_params = _jax_steps(arch, smooth=True)
    jg = state_dict_from_jax({"params": grads["params"]})
    m, got_g, _, _ = _port_full_step(arch, smooth=True)
    for k in metrics[0]:
        assert rel_err(m[k].numpy(), metrics[0][k]) <= 1e-5, k
    names = sorted(got_g)
    assert rel_err(_flat(got_g, names), _flat(jg, names)) <= 1e-4
    got, port = _port_two_steps(arch, smooth=True)
    for k in metrics[1]:
        assert rel_err(got[1][k].numpy(), metrics[1][k]) <= 1e-5, k
    assert _update_gap(params, after_params, port) <= 1e-4


def test_jax_default_optimizer_moves_frozen_bn_the_port_does_not():
    """The JAX package's own optimizer for MinVIS (``build_optimizer``: no
    ``model.freeze``) applied to a MinVIS step's gradients moves the
    FrozenBN means and variances (at 0.1 x the learning rate, no decay);
    the port's train step, the backbone trained, leaves its
    FrozenBatchNorm2d buffers as they were."""
    cfg, _, params = _cfg("minvis")
    _, grads, _, _ = _jax_steps("minvis")
    tx = jax_build_optimizer(cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), tx.init(jparams), jparams)
    moved = {jopt._path_str(p): float(jnp.abs(u).max())
             for p, u in jax.tree_util.tree_flatten_with_path(updates)[0]
             if _frozen_bn(jopt._path_str(p)) and jopt._path_str(p).split("/")[-1] in ("mean", "var")}
    assert moved and all(v > 0 for v in moved.values()), moved

    _, _, before, after = _port_full_step("minvis")
    assert any(k.endswith("running_var") for k in before)
    for k, v in after.items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("arch", ["minvis", "ctvis"])
def test_groups_and_decay_match_jax(arch):
    """The trained segmenter (the ReID branch with CTVIS): every port
    parameter's group (``backbone`` at 0.1 x the rate, else ``main``) and
    weight-decay flag equal the JAX leaves' it converts from; the JAX leaves
    no port parameter holds are the FrozenBN ones (buffers in the port)."""
    from dvis_plus_tpu_torch.engine import optimizer as popt

    cfg, _, params = jax_minvis_model_and_params(arch)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    ids = [np.full(np.shape(x), i + 1, np.float32) for i, (_, x) in enumerate(leaves)]
    sd = state_dict_from_jax(jax.tree_util.tree_unflatten(treedef, ids))
    frozen = jopt.make_frozen_predicate(cfg.model.freeze)
    model = port_arch_model(cfg, params)
    pfrozen = popt.make_frozen_predicate(cfg.model.freeze)
    seen = set()
    for name, p in model.named_parameters():
        which = {int(v) for v in np.unique(sd[name].numpy())}
        seen |= which
        for i in which:
            path = jopt._path_str(leaves[i - 1][0])
            label = "frozen" if frozen(path) else ("backbone" if jopt._is_backbone(path) else "main")
            assert label == popt.group_label(name, pfrozen) != "frozen", name
            assert jopt._no_weight_decay(path, np.asarray(leaves[i - 1][1])) == popt.no_weight_decay(name, p), name
    assert any("reid_embed" in n for n, _ in model.named_parameters()) == (arch == "ctvis")
    rest = {jopt._path_str(leaves[i - 1][0]) for i in range(1, len(leaves) + 1)} - {
        jopt._path_str(leaves[i - 1][0]) for i in seen}
    assert rest and all(_frozen_bn(p) for p in rest), sorted(rest)[:5]
