"""The tracker's training path and the DVIS++ online loss against the JAX
package's, with the JAX draws answered to the port by site
(``tests/test_torch_common.py::noise_draws`` / ``online_loss_draws``).

Bars: the noiser's indices equal and inits rel <= 1e-6 in all four modes;
the training forward over T = 5 (every layer's logits and masks, the
references, the indices) rel <= 1e-4, the recurrent tracker's bar
(PARITY.md); ``dvis_online_train_loss``, every key, rel <= 1e-5 with the
matcher guided by the segmenter and matching on its own outputs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.losses.criterion import CriterionConfig as JaxCriterionConfig
from dvis_plus_tpu.losses.targets import VideoTargets as JaxTargets
from dvis_plus_tpu.models.meta.dvis_online import dvis_online_train_loss as jax_online_loss
from dvis_plus_tpu.models.tracker import referring_tracker as jrt
from dvis_plus_tpu_torch.losses.criterion import CriterionConfig
from dvis_plus_tpu_torch.losses.targets import VideoTargets
from dvis_plus_tpu_torch.models.meta.dvis_online import dvis_online_train_loss
from dvis_plus_tpu_torch.models.tracker import referring_tracker as prt
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
T, BATCH = 5, 2


@pytest.mark.parametrize("mode", ["none", "rs", "wa", "cc"])
def test_noiser_matches_jax(mode):
    rng = np.random.RandomState(0)
    Bn, Q, C = 6, 8, 16
    ref, cur, cur_nn = (rng.randn(Bn, Q, C).astype(np.float32) for _ in range(3))
    key = jax.random.key(1)
    want = [jrt.noiser(k, jnp.asarray(ref[b]), jnp.asarray(cur[b]), jnp.asarray(cur_nn[b]),
                       jnp.asarray(True), 0.5, mode, "jv") for b, k in enumerate(jax.random.split(key, Bn))]
    # the draws of row b come from split(key, Bn)[b], as in one frame of the tracker
    rows = {}
    for kb in jax.random.split(key, Bn):
        k1, k2 = jax.random.split(kb)
        rows.setdefault("gate", []).append(np.asarray(jax.random.uniform(k1)))
        if mode == "rs":
            rows.setdefault("perm", []).append(np.asarray(jax.random.permutation(k2, Q)))
        elif mode == "wa":
            ka, kw = jax.random.split(k2)
            rows.setdefault("perm", []).append(np.asarray(jax.random.permutation(ka, Q)))
            rows.setdefault("weight", []).append(np.asarray(jax.random.uniform(kw, (Q, 1))))
        elif mode == "cc":
            ks, kp = jax.random.split(k2)
            rows.setdefault("split", []).append(np.asarray(jax.random.randint(ks, (Q, 1), 0, C)))
            rows.setdefault("perm", []).append(np.asarray(jax.random.permutation(kp, Q)))
    table = {("noise", 0, k): np.stack(v) for k, v in rows.items()}
    draws = JaxDraws(table)
    matched = torch.stack([prt.match_embds(torch.from_numpy(ref[b]), torch.from_numpy(cur[b]), "jv")
                           for b in range(Bn)])
    use = draws.uniform(("noise", 0, "gate"), (Bn,)) < 0.5
    assert 0 < int(use.sum()) < Bn  # some rows noised, some not
    idx, init = prt.noiser(matched, torch.from_numpy(cur_nn), use, mode, draws, 0)
    np.testing.assert_array_equal(idx.numpy(), np.stack([np.asarray(w[0]) for w in want]))
    assert rel_err(init.numpy(), np.stack([np.asarray(w[1]) for w in want])) <= 1e-6


def _ccfg(cfg, jax_side):
    """The loss weights x100: the random model's queries cost nearly the same
    (within some 0.05 at the default weights), and the JAX JV solves in fp32
    beside pad costs of 1e6 and 2e6, so it tells costs apart only to about
    0.1 (scipy, the port's solver, works in fp64); scaled, the costs lie
    further apart than that."""
    kind = JaxCriterionConfig if jax_side else CriterionConfig
    return kind(num_classes=cfg.model.num_classes, num_points=200, class_weight=200.0,
                mask_weight=500.0, dice_weight=500.0)


def _targets(N=4, seed=3):
    """Clips at the stride-4 size: instance 1 first seen in frame 2, the last
    slot padding."""
    rng = np.random.RandomState(seed)
    h, w = H_IN // 4, W_IN // 4
    masks = np.zeros((BATCH, N, T, h, w), bool)
    fv = np.zeros((BATCH, N, T), bool)
    for b in range(BATCH):
        for n in range(N - 1):
            y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
            for t in range(T):
                if n == 1 and t < 2:
                    continue
                masks[b, n, t, y:y + 6, x + t:x + 7 + t] = True
                fv[b, n, t] = True
    labels = rng.randint(0, 5, (BATCH, N)).astype(np.int32)
    return labels, masks, fv.any(-1), fv


@functools.cache
def _runs():
    """The JAX model's training forward (rng r1) and the port's with the JAX
    noise; noise ratio 0.5, mode wa."""
    cfg, model, params = jax_model_and_params()
    x = np.stack([images(T, seed=21 + b) for b in range(BATCH)])
    key = jax.random.key(11)
    r1, r2 = jax.random.split(key)
    seg_out, track_out, _ = jax.jit(lambda p, im, r: model.apply(p, im, rng=r, training=True))(
        params, jnp.asarray(x), r1)
    port = port_model(cfg, params)
    C2 = 2 * cfg.model.transformer_decoder.hidden_dim
    draws = JaxDraws(noise_draws(r1, T, BATCH, cfg.model.transformer_decoder.num_queries, C2, "wa"))
    p_seg, p_track = port.train_forward(torch.stack([nchw(v) for v in x]), draws)
    gates = np.stack([draws.table[("noise", t, "gate")] for t in range(1, T)])
    assert 0 < (gates < 0.5).sum() < gates.size  # the noise fired on some frames, not all
    return cfg, seg_out, track_out, p_seg, p_track, r2


def test_training_forward_matches_jax():
    cfg, _, want, _, got, _ = _runs()
    L = cfg.model.tracker.num_layers
    assert len(got["aux_pred_logits"]) == len(want["aux_pred_logits"]) == L - 1
    np.testing.assert_array_equal(got["indices"].numpy(), np.asarray(want["indices"]))
    assert rel_err(got["pred_references"].detach().numpy(), want["pred_references"]) <= 1e-4
    for k in ("pred_logits", "pred_masks", "pred_embds"):
        assert rel_err(got[k].detach().numpy(), want[k]) <= 1e-4, k
    for k in ("aux_pred_logits", "aux_pred_masks"):
        for g, w in zip(got[k], want[k]):
            assert rel_err(g.detach().numpy(), w) <= 1e-4, k


@pytest.mark.parametrize("guided", [True, False], ids=["guided", "self"])
def test_online_train_loss_matches_jax(guided):
    cfg, seg_out, track_out, p_seg, p_track, r2 = _runs()
    labels, masks, valid, fv = _targets()
    jt = JaxTargets(labels=jnp.asarray(labels), masks=jnp.asarray(masks), valid=jnp.asarray(valid),
                    frame_valid=jnp.asarray(fv))
    pt = VideoTargets(torch.from_numpy(labels).long(), torch.from_numpy(masks),
                      torch.from_numpy(valid), torch.from_numpy(fv))
    jccfg = _ccfg(cfg, True)
    want = jax.jit(lambda r, s, o, t: jax_online_loss(r, s, o, t, jccfg, jnp.asarray(guided)))(
        r2, seg_out, track_out, jt)
    n_aux = cfg.model.tracker.num_layers - 1
    table = online_loss_draws(r2, BATCH, labels.shape[1], T, n_aux, jccfg)
    got = dvis_online_train_loss(p_seg, p_track, pt, _ccfg(cfg, False), guided, JaxDraws(table))
    assert sorted(got) == sorted(want)
    for k in want:
        assert rel_err(got[k].detach().numpy(), want[k]) <= 1e-5, k
