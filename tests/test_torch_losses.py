"""The port's point sampling, matchers and losses against the JAX package's
on the same numpy inputs, with the JAX draws answered to the port by site
(``tests/test_torch_common.py::JaxDraws``).

Bars: point sampling rel <= 1e-6 and the same importance picks; matcher
costs rel <= 1e-5 and equal assignments under ``jv`` and ``auction`` (only
where a slot is valid, or, for the consistent matcher, where a match was
accepted: the exact solvers may break ties among pad columns differently);
``loss_labels``, ``loss_masks``, ``reid_loss`` and ``video_criterion``
values rel <= 1e-5, gradients with respect to the predictions rel <= 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.losses import criterion as jc
from dvis_plus_tpu.losses import matcher as jm
from dvis_plus_tpu.losses.reid import reid_loss as jax_reid_loss
from dvis_plus_tpu.losses.targets import VideoTargets as JaxTargets
from dvis_plus_tpu.ops import point_sample as jps
from dvis_plus_tpu_torch.losses import criterion as pc
from dvis_plus_tpu_torch.losses import matcher as pm
from dvis_plus_tpu_torch.losses.reid import reid_loss
from dvis_plus_tpu_torch.losses.targets import VideoTargets
from dvis_plus_tpu_torch.ops import point_sample as pps
from tests.test_torch_common import (
    JaxDraws,
    add_points,
    clip_match_coords,
    consistent_match_coords,
    loss_points,
    rel_err,
)

torch.set_num_threads(2)
B, Q, N, T, H, W, K, P = 2, 10, 6, 3, 16, 20, 5, 256


def scene(seed=0, n_real=4):
    """Padded targets (capacity N, n_real instances a clip): instance 1 first
    appears in frame 1, instance 2 in frame 2, instance 3 is absent from
    frame 1; the slots past n_real are padding."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, K, size=(B, N)).astype(np.int32)
    masks = np.zeros((B, N, T, H, W), bool)
    fv = np.zeros((B, N, T), bool)
    for b in range(B):
        for n in range(n_real):
            y, x = rng.randint(0, H - 7), rng.randint(0, W - 7)
            for t in range(T):
                if (n == 1 and t < 1) or (n == 2 and t < 2) or (n == 3 and t == 1):
                    continue
                masks[b, n, t, y:y + 5 + n % 3, x + t:x + 6 + t] = True
                fv[b, n, t] = True
    return labels, masks, fv.any(-1), fv


def both_targets(labels, masks, valid, fv):
    return (JaxTargets(labels=jnp.asarray(labels), masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                       frame_valid=jnp.asarray(fv)),
            VideoTargets(torch.from_numpy(labels).long(), torch.from_numpy(masks),
                         torch.from_numpy(valid), torch.from_numpy(fv)))


def predictions(seed=1, per_frame=True):
    rng = np.random.RandomState(seed)
    shape = (B, T, Q, K + 1) if per_frame else (B, Q, K + 1)
    return (rng.randn(*shape).astype(np.float32) * 2,
            rng.randn(B, Q, T, H, W).astype(np.float32) * 3)


@pytest.mark.parametrize("kind", ["float", "bool"])
@pytest.mark.parametrize("shared", [False, True])
def test_point_sample_matches_jax(kind, shared):
    rng = np.random.RandomState(0)
    masks = rng.randn(3, 4, H, W).astype(np.float32)
    if kind == "bool":
        masks = masks > 0.3
    coords = rng.rand(3, 1 if shared else 4, 70, 2).astype(np.float32)
    coords[0, 0, :4] = [[0.0, 0.0], [0.999, 0.999], [0.0, 0.999], [0.5, 0.0]]  # the edges
    want = np.asarray(jps.point_sample(jnp.asarray(masks), jnp.asarray(coords)))
    got = pps.point_sample(torch.from_numpy(masks), torch.from_numpy(coords)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert rel_err(got, want) <= 1e-6


def test_uncertain_point_coords_pick_as_jax():
    logits = np.random.RandomState(2).randn(6, H, W).astype(np.float32)
    logits[0] = 0.0  # all equally uncertain: the order among equals decides the picks
    key = jax.random.key(3)
    want = np.asarray(jps.uncertain_point_coords_with_randomness(key, jnp.asarray(logits), 40, 3.0, 0.75))
    over, fill = loss_points(key, 6, jc.CriterionConfig(num_classes=K, num_points=40))
    got = pps.uncertain_point_coords_with_randomness(
        torch.from_numpy(logits), 40, 3.0, 0.75, coords=(torch.from_numpy(over), torch.from_numpy(fill)))
    np.testing.assert_array_equal(got.numpy(), want)
    # drawn from a generator: the shape and range, and the same seed draws the same
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    a = pps.uncertain_point_coords_with_randomness(torch.from_numpy(logits), 40, 3.0, 0.75, generator=g1)
    b = pps.uncertain_point_coords_with_randomness(torch.from_numpy(logits), 40, 3.0, 0.75, generator=g2)
    assert a.shape == (6, 40, 2) and torch.equal(a, b) and 0.0 <= float(a.min()) and float(a.max()) < 1.0


def test_costs_match_jax():
    rng = np.random.RandomState(4)
    logits, src = rng.randn(Q, K + 1).astype(np.float32), rng.randn(Q, P).astype(np.float32) * 3
    tgt = (rng.rand(N, P) > 0.6).astype(np.float32)
    labels = rng.randint(0, K, N)
    costs = jm.MatchCosts()
    for jf, pf in ((jm.batch_sigmoid_ce_cost, pm.batch_sigmoid_ce_cost),
                   (jm.batch_dice_cost, pm.batch_dice_cost)):
        assert rel_err(pf(torch.from_numpy(src), torch.from_numpy(tgt)).numpy(),
                       jf(jnp.asarray(src), jnp.asarray(tgt))) <= 1e-5
    want = jm._pair_cost(jnp.asarray(logits), jnp.asarray(src), jnp.asarray(labels), jnp.asarray(tgt), costs)
    got = pm._pair_cost(torch.from_numpy(logits), torch.from_numpy(src), torch.from_numpy(labels),
                        torch.from_numpy(tgt), pm.MatchCosts())
    assert rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("solver", ["jv", "auction"])
@pytest.mark.parametrize("n_real", [4, 6], ids=["padded", "full"])
def test_matchers_assign_as_jax(solver, n_real):
    jt, pt = both_targets(*scene(n_real=n_real))
    logits_t, masks = predictions()
    key = jax.random.key(5)
    jcosts, pcosts = jm.MatchCosts(num_points=P, solver=solver), pm.MatchCosts(num_points=P, solver=solver)
    valid = np.asarray(jt.valid)

    # clip matching (per-frame logits averaged, as the criterion's clip mode)
    clip_logits = logits_t.mean(axis=1)
    want = np.asarray(jax.jit(lambda *a: jm.video_hungarian_match(*a, jcosts))(
        key, jnp.asarray(clip_logits), jnp.asarray(masks), jt))
    got = pm.video_hungarian_match(torch.from_numpy(clip_logits), torch.from_numpy(masks), pt,
                                   torch.from_numpy(clip_match_coords(key, B, P)), pcosts).numpy()
    np.testing.assert_array_equal(got[valid], want[valid])

    # consistent matching
    masks_t = np.ascontiguousarray(np.swapaxes(masks, 1, 2))
    want = np.asarray(jax.jit(lambda *a: jm.consistent_match(*a, jcosts))(
        key, jnp.asarray(logits_t), jnp.asarray(masks_t), jt))
    got = pm.consistent_match(torch.from_numpy(logits_t), torch.from_numpy(masks_t), pt,
                              torch.from_numpy(consistent_match_coords(key, B, T, P)), pcosts).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(want[valid] >= 0) and np.all(want[~valid] == -1)
    for b in range(B):  # one query a ground truth
        assert len(set(got[b][valid[b]].tolist())) == int(valid[b].sum())


def _ccfg(jax_side=True, **kw):
    mod = jc if jax_side else pc
    return mod.CriterionConfig(num_classes=K, num_points=P, **kw)


def test_loss_labels_and_masks_match_jax_with_grads():
    jt, pt = both_targets(*scene())
    logits_t, masks = predictions(seed=6)
    q4g = np.stack([np.random.RandomState(b).permutation(Q)[:N] for b in range(B)]).astype(np.int32)
    q4g[0, 1] = -1  # a valid slot left unmatched
    num_masks = 7.0
    key = jax.random.key(7)

    def jax_losses(lg, mk):
        ce = jc.loss_labels(lg, jt, jnp.asarray(q4g), _ccfg())
        ml = jc.loss_masks(key, mk, jt, jnp.asarray(q4g), jnp.float32(num_masks), _ccfg())
        return ce, ml["loss_mask"], ml["loss_dice"]

    args = (jnp.asarray(logits_t), jnp.asarray(masks))
    want = [np.asarray(v) for v in jax.jit(jax_losses)(*args)]
    want_g = [[np.asarray(g) for g in jax.jit(jax.grad(lambda a, b, i=i: jax_losses(a, b)[i],
                                                       argnums=(0, 1)))(*args)] for i in range(3)]

    table = {}
    add_points(table, "final", key, B * N * T, _ccfg())
    for i in range(3):
        lg = torch.from_numpy(logits_t).requires_grad_()
        mk = torch.from_numpy(masks).requires_grad_()
        ce = pc.loss_labels(lg, pt, torch.from_numpy(q4g).long(), _ccfg(False))
        ml = pc.loss_masks(mk, pt, torch.from_numpy(q4g).long(), torch.tensor(num_masks), _ccfg(False),
                           JaxDraws(table), "final")
        got = (ce, ml["loss_mask"], ml["loss_dice"])
        assert rel_err(got[i].detach().numpy(), want[i]) <= 1e-5, i
        got[i].backward()
        wrt, jax_g = (lg, want_g[i][0]) if i == 0 else (mk, want_g[i][1])
        assert rel_err(wrt.grad.numpy(), jax_g) <= 1e-4, i


def test_reid_loss_matches_jax_with_grads():
    rng = np.random.RandomState(8)
    refs = rng.randn(B, T + 1, Q, 12).astype(np.float32)
    q4g = np.stack([rng.permutation(Q)[:N] for _ in range(B)]).astype(np.int32)
    q4g[1, 2] = -1
    valid = np.ones((B, N), bool)
    valid[0, 4:] = False

    def f(r):
        out = jax_reid_loss(r, jnp.asarray(q4g), jnp.asarray(valid))
        return out["loss_reid"], out["loss_aux_reid"]

    for i in range(2):
        want = np.asarray(jax.jit(f)(jnp.asarray(refs))[i])
        want_g = np.asarray(jax.jit(jax.grad(lambda r: f(r)[i]))(jnp.asarray(refs)))
        r = torch.from_numpy(refs).requires_grad_()
        got = reid_loss(r, torch.from_numpy(q4g).long(), torch.from_numpy(valid))
        val = got[("loss_reid", "loss_aux_reid")[i]]
        assert rel_err(val.detach().numpy(), want) <= 1e-5
        val.backward()
        assert rel_err(r.grad.numpy(), want_g) <= 1e-4


@pytest.mark.parametrize("guided", [False, True])
def test_video_criterion_matches_jax(guided):
    """Clip mode over a final and two auxiliary layers, each re-matched on its
    own outputs, or all on a guiding model's outputs."""
    jt, pt = both_targets(*scene())
    layers = [predictions(seed=10 + i, per_frame=False) for i in range(3)]
    guide = predictions(seed=20, per_frame=False)
    key = jax.random.key(9)
    J = lambda lm: jc.LayerOutputs(jnp.asarray(lm[0]), jnp.asarray(lm[1]))  # noqa: E731
    Pt = lambda lm: pc.LayerOutputs(torch.from_numpy(lm[0]), torch.from_numpy(lm[1]))  # noqa: E731
    want, want_q = jax.jit(lambda k, o, a, t, g: jc.video_criterion(k, o, a, t, _ccfg(), matcher_outputs=g))(
        key, J(layers[0]), [J(x) for x in layers[1:]], jt, J(guide) if guided else None)

    rngs = jax.random.split(key, 2 * 3)
    table = {("match", "final"): clip_match_coords(rngs[0], B, P)}
    add_points(table, "final", rngs[1], B * N * T, _ccfg())
    for i in range(2):
        table[("match", i)] = clip_match_coords(rngs[2 + 2 * i], B, P)
        add_points(table, i, rngs[3 + 2 * i], B * N * T, _ccfg())
    got, got_q = pc.video_criterion(Pt(layers[0]), [Pt(x) for x in layers[1:]], pt, _ccfg(False),
                                    JaxDraws(table), matcher_outputs=Pt(guide) if guided else None)
    assert sorted(got) == sorted(want)
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-5, k
    valid = np.asarray(jt.valid)
    np.testing.assert_array_equal(got_q.numpy()[valid], np.asarray(want_q)[valid])
