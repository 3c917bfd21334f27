"""Open-vocabulary training (the FC-CLIP segmenter, OV-DVIS++ online and
offline) against the JAX package on the same weights, batch and text
classifier, with the JAX draws answered to the port by site
(``tests/test_torch_common.py::JaxDraws``).

The model is the tiny OV model of the eval parity tests
(``tests/test_torch_common.py::tiny_ov_cfg``: a ConvNeXt trunk of widths 16
to 40, CLIP embedding 24, 8 queries, 5 classes of 3 templates, two decoder,
tracker and refiner layers, so that every layer's outputs of the tracker and
the refiner are held), fp32, exact deformable op, JV matchers (tracker and
criterion), loss weights x100 (as ``tests/test_torch_train.py``), trained as
the OV YAMLs freeze it: ``minvis_ov`` and ``dvis_online_ov`` with
``freeze: [backbone]``, ``dvis_offline_ov`` with ``[backbone, segmenter,
tracker]``.

Bars, for each architecture against ``engine/trainer.py::build_train_step``
(one JAX executable an architecture, its raw gradients kept by a first
optax stage): every loss of two steps rel <= 1e-5; step 0's gradients of
the trained parameters rel <= 1e-4; the update after two steps within 1e-4
of the JAX one as a norm; what neither trains unchanged on both sides.

The findings, each with the JAX behaviour beside the port's:

- the void rows under ``freeze: [..., segmenter, ...]`` stay fixed in the
  offline stage, as the JAX step leaves them (the repair: the port's rows
  sit at the top level, outside the ``segmenter`` prefixes);
- DVIS++ OV online with ``solver.weight_decay`` > 0: the JAX optimizer
  decays the segmenter's decoders, whose gradients are zero (the module's
  ``stop_gradient``), every step; the port runs them without gradients and
  out of the optimizer, as the reference does (so the parity step runs at
  ``weight_decay=0``);
- the merged void rows (``void_index=None``) carry no gradient, as the JAX
  ``stop_gradient``; a private row does.

And the mixture: two sets of different class counts with
``num_void_embeddings: 2``, each step routed by the batch's
``dataset_index`` to its set's classifier and void row; only that row gets a
gradient, and the one optimizer counts one update a step.
"""
import copy
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
from dvis_plus_tpu.models.meta import ov as jov
from dvis_plus_tpu.models.ov.heads import mask_pooling as jax_mask_pooling
from dvis_plus_tpu_torch.cli_ov import build_ov_model
from dvis_plus_tpu_torch.convert import state_dict_from_jax
from dvis_plus_tpu_torch.engine.trainer import Batch, Classifier, build_train_step
from dvis_plus_tpu_torch.models.ov.heads import mask_pooling
from tests.test_torch_common import (
    JaxDraws,
    jax_ov_model_and_params,
    nchw,
    noise_draws,
    online_loss_draws,
    ov_text_classifier,
    rel_err,
)
from tests.test_torch_minvis_train import _batch, _capture, _targets, criterion_draws
from tests.test_torch_offline_train import offline_loss_draws

torch.set_num_threads(2)
T, BATCH, N = 3, 2, 4
FREEZE = {"minvis_ov": ("backbone",), "dvis_online_ov": ("backbone",),
          "dvis_offline_ov": ("backbone", "segmenter", "tracker")}
# what each architecture trains (the port's names)
TRAINED = {"minvis_ov": ("sem_seg_head.", "void_embedding."), "dvis_online_ov": ("tracker.", "void_embedding."),
           "dvis_offline_ov": ("refiner.",)}
JAX_MODELS = {"minvis_ov": jov.OVSegmenter, "dvis_online_ov": jov.DVISOnlineOV,
              "dvis_offline_ov": jov.DVISOfflineOV}


def _cfg(arch, weight_decay=0.0):
    """(cfg, JAX module, numpy params): the tiny OV model of ``arch`` with JV
    matchers, as its YAML freezes it."""
    cfg, _, params, _ = jax_ov_model_and_params("convnext", arch)
    cfg = copy.deepcopy(cfg)  # the cached config stays as it is
    m = cfg.model
    m.tracker.matcher_solver = m.criterion.matcher_solver = "jv"
    m.freeze = FREEZE[arch]
    c = m.criterion
    c.train_num_points, c.class_weight, c.mask_weight, c.dice_weight = 200, 200.0, 500.0, 500.0
    s = cfg.solver
    s.max_iter, s.warmup_iters, s.warmup_factor, s.weight_decay = 100, 3, 0.5, weight_decay
    return cfg, JAX_MODELS[arch](m), params


def _torch_batch(dataset_index=0):
    x, labels, masks, valid, fv = _batch()
    return Batch(torch.stack([nchw(v) for v in x]), _targets(labels, masks, valid, fv)[1], dataset_index)


def _ccfg(cfg):
    return jax_criterion_config(cfg)._replace(num_classes=len(ov_text_classifier()[1]) - 1)


def _step_draws(cfg, step, arch):
    """The JAX step's draws: fold the step into key(seed); MinVIS OV gives the
    key to its criterion whole, the DVIS++ ones split it into the model's
    (the tracker's noise online; unused offline) and the loss's."""
    key = jax.random.fold_in(jax.random.key(cfg.seed), step)
    ccfg = _ccfg(cfg)
    if arch == "minvis_ov":
        return JaxDraws(criterion_draws(key, BATCH * T, cfg.model.transformer_decoder.dec_layers, ccfg,
                                        ccfg.num_points))
    r1, r2 = jax.random.split(key)
    if arch == "dvis_online_ov":
        td = cfg.model.transformer_decoder
        table = noise_draws(r1, T, BATCH, td.num_queries, td.hidden_dim, "wa")
        table.update(online_loss_draws(r2, BATCH, N, T, cfg.model.tracker.num_layers - 1, ccfg))
        return JaxDraws(table)
    return JaxDraws(offline_loss_draws(r2, BATCH, cfg.model.refiner.num_layers - 1, ccfg, T))


@functools.cache
def _jax_steps(arch):
    """Two JAX train steps with the test classifier and void row 0: (each
    step's metrics, step 0's raw gradients, the parameters after)."""
    cfg, model, params = _cfg(arch)
    tc, nt, _ = ov_text_classifier()
    x, labels, masks, valid, fv = _batch()
    jbatch = JaxBatch(images=jnp.asarray(x), targets=_targets(labels, masks, valid, fv)[0])
    step_fn, init_state = jax_build_train_step(
        cfg, model, optimizer=optax.chain(_capture(), jax_build_optimizer(cfg)), text_classifier=tc,
        num_templates=nt, void_index=0)
    state = init_state(jax.tree_util.tree_map(jnp.asarray, params))
    metrics, grads = [], None
    for step in range(2):
        state, m = step_fn(state, jbatch, jax.random.key(cfg.seed))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
        if step == 0:
            grads = jax.tree_util.tree_map(np.asarray, state.opt_state[0])
    return metrics, grads, jax.tree_util.tree_map(np.asarray, state.params)


def _port(cfg, params):
    model = build_ov_model(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.train()


def test_minvis_ov_train_step_matches_jax():
    """The FC-CLIP segmenter: the pixel and query decoders and void row 0
    train, the CLIP trunk stays fixed."""
    check_train_step_matches_jax("minvis_ov")


def _classifier(void_index=0):
    tc, nt, _ = ov_text_classifier()
    return Classifier(torch.from_numpy(tc), nt, void_index)


def check_train_step_matches_jax(arch):
    """Two port steps against :func:`_jax_steps`, at the bars of the module
    docstring."""
    cfg, _, params = _cfg(arch)
    metrics, grads, after_params = _jax_steps(arch)
    port = _port(cfg, params)
    train_step, init = build_train_step(cfg, port, [_classifier()])
    state = init()
    batch = _torch_batch()
    trained = [n for n, p in port.named_parameters() if p.requires_grad]
    assert trained and all(n.startswith(TRAINED[arch]) for n in trained)
    assert {n.split(".")[0] for n in trained} == {p.rstrip(".") for p in TRAINED[arch]}
    for step in range(2):
        state, m = train_step(state, batch, _step_draws(cfg, step, arch))
        assert sorted(m) == sorted([*metrics[step], "grad_norm"])
        for k in metrics[step]:
            assert rel_err(m[k].numpy(), metrics[step][k]) <= 1e-5, (step, k)
        if step == 0:
            jg = state_dict_from_jax({"params": grads["params"]})
            got_g = np.concatenate([dict(port.named_parameters())[n].grad.numpy().ravel() for n in trained])
            assert rel_err(got_g, np.concatenate([jg[n].numpy().ravel() for n in trained])) <= 1e-4
    assert state.optimizer.count == 2
    before, after = state_dict_from_jax(params), state_dict_from_jax(after_params)
    sd = port.state_dict()
    d_port = np.concatenate([(sd[k] - before[k]).numpy().ravel() for k in trained])
    d_jax = np.concatenate([(after[k] - before[k]).numpy().ravel() for k in trained])
    assert np.abs(d_jax).max() > 0
    assert np.linalg.norm(d_port - d_jax) / np.linalg.norm(d_jax) <= 1e-4
    for k in sd:  # the frozen parts, on both sides (the offline void row among them)
        if k not in trained:
            assert torch.equal(sd[k], before[k]) and torch.equal(after[k], before[k]), k


@pytest.mark.parametrize("void_index", [0, None], ids=["private", "merged"])
def test_full_classifier_gradient_matches_jax(void_index):
    """Two void rows (mode ``mean`` when merged): the gradient of a loss of
    the classifier with respect to the rows, in both packages; merged, the
    rows are detached in both."""
    cfg, model, params = _cfg("minvis_ov")
    cfg.model.ov.num_void_embeddings, cfg.model.ov.void_merge_mode = 2, "mean"
    jm = jov.OVSegmenter(cfg.model)
    tc = ov_text_classifier()[0]
    rows = np.random.RandomState(5).randn(2, tc.shape[1]).astype(np.float32)
    w = np.random.RandomState(6).randn(tc.shape[0] + 1, tc.shape[1]).astype(np.float32)

    def jloss(v):
        p = {"params": {"void_embedding": v}}
        full = jm.apply(p, jnp.asarray(tc), void_index, method=lambda m, t, i: m.full_classifier(t, i))
        return jnp.sum(full * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(rows)))
    port = build_ov_model(cfg)
    with torch.no_grad():
        port.void_embedding.weight.copy_(torch.from_numpy(rows[:1]))
        port.additional_void_embedding.weight.copy_(torch.from_numpy(rows[1:]))
    full = port.full_classifier(torch.from_numpy(tc), void_index)
    assert full.requires_grad == (void_index is not None)
    assert (np.abs(want).max() > 0) == (void_index is not None)
    if void_index is not None:
        (full * torch.from_numpy(w)).sum().backward()
        got = torch.cat([port.void_embedding.weight.grad, port.additional_void_embedding.weight.grad])
        assert rel_err(got.numpy(), want) <= 1e-6
        assert np.array_equal(got.numpy() != 0, want != 0)


def test_mask_pooling_gradient_matches_jax():
    """The features carry the gradient, the binary masks none: the JAX
    ``stop_gradient``; masks at another size are resized first."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 10, 12).astype(np.float32)  # (B, C, H, W)
    mask = rng.randn(2, 5, 20, 24).astype(np.float32)
    w = rng.randn(2, 5, 6).astype(np.float32)

    def f(x_, m_):
        return jnp.sum(jax_mask_pooling(jnp.moveaxis(x_, 1, -1), m_) * w)

    gx, gm = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(mask))
    xt, mt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(mask).requires_grad_()
    out = mask_pooling(xt, mt)
    assert rel_err(out.detach().numpy(), np.asarray(jax_mask_pooling(jnp.moveaxis(x, 1, -1), mask))) <= 1e-6
    (out * torch.from_numpy(w)).sum().backward()
    assert rel_err(xt.grad.numpy(), np.asarray(gx)) <= 1e-6
    assert np.abs(np.asarray(gm)).max() == 0 and mt.grad is None


def test_mixture_routes_each_batch_to_its_sets_classifier():
    """Two training sets, 5 classes of 3 templates and 3 classes of 2, void
    rows 0 and 1: the batches of steps 0-3 come from sets 0, 1, 1, 0. Each
    step scores against its set's classifier and trains its void row alone;
    one optimizer counts the steps."""
    cfg, _, params = _cfg("dvis_online_ov")
    cfg.model.ov.num_void_embeddings = 2
    torch.manual_seed(0)
    port = build_ov_model(cfg)
    sd = state_dict_from_jax(params)
    sd["additional_void_embedding.weight"] = torch.randn(1, sd["void_embedding.weight"].shape[1])
    port.load_state_dict(sd, strict=True)
    port.train()
    tc0 = ov_text_classifier()[0]
    tc1 = np.random.RandomState(9).randn(6, tc0.shape[1]).astype(np.float32)
    sets = [Classifier(torch.from_numpy(tc0), ov_text_classifier()[1], 0),
            Classifier(torch.from_numpy(tc1), (2, 2, 2, 1), 1)]
    train_step, init = build_train_step(cfg, port, sets)
    state = init()
    seen, with_void = [], port.with_void

    def recording(text_classifier, num_templates, void_index=None):
        if text_classifier.shape[0] < sum(num_templates):  # the call that appends the void row
            seen.append((text_classifier.shape[0], tuple(num_templates), void_index))
        return with_void(text_classifier, num_templates, void_index)

    port.with_void = recording
    rows = (port.void_embedding.weight, port.additional_void_embedding.weight)
    start = [r.detach().clone() for r in rows]
    for step, index in enumerate((0, 1, 1, 0)):
        x, labels, masks, valid, fv = _batch(seed=3 + step)
        labels = labels % len(sets[index].num_templates[:-1])
        batch = Batch(torch.stack([nchw(v) for v in x]), _targets(labels, masks, valid, fv)[1], index)
        seen.clear()
        state, metrics = train_step(state, batch)
        assert np.isfinite(float(metrics["total_loss"]))
        assert seen and set(seen) == {(len(sets[index].text_classifier), sets[index].num_templates, index)}
        assert state.optimizer.count == step + 1 and state.step == step + 1
        assert rows[index].grad.abs().max() > 0 and rows[1 - index].grad.abs().max() == 0, step
        if step == 0:  # weight decay 0: no moment yet, no update for row 1
            assert not torch.equal(rows[0], start[0]) and torch.equal(rows[1], start[1])
