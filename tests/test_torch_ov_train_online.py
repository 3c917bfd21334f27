"""DVIS++ OV online training (the tracker on the segmenter, which runs
without gradients) against the JAX package: the step at the bars of
``tests/test_torch_ov_train.py`` (one JAX executable), and finding 2 of
that file's docstring, the JAX optimizer's weight decay on the segmenter's
zero-gradient decoders, beside the port's step, which leaves them fixed."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dvis_plus_tpu.engine.trainer import build_optimizer as jax_build_optimizer
from dvis_plus_tpu_torch.convert import state_dict_from_jax
from dvis_plus_tpu_torch.engine.trainer import build_train_step
from tests.test_torch_ov_train import (
    _cfg,
    _classifier,
    _jax_steps,
    _port,
    _step_draws,
    _torch_batch,
    check_train_step_matches_jax,
)

torch.set_num_threads(2)


def test_dvis_online_ov_train_step_matches_jax():
    """The tracker and void row 0 train; the segmenter stays fixed (the
    parity step at ``solver.weight_decay=0``, where the JAX optimizer leaves
    it fixed too)."""
    check_train_step_matches_jax("dvis_online_ov")


def test_jax_step_decays_the_online_segmenter_the_port_does_not():
    """DVIS++ OV online at ``solver.weight_decay=0.05``: the JAX segmenter's
    gradients are zero, and its optimizer still moves the decayed decoder
    weights by -lr x wd x w; the port's segmenter stays as it was."""
    cfg, _, params = _cfg("dvis_online_ov", weight_decay=0.05)
    _, grads, _ = _jax_steps("dvis_online_ov")
    seg = grads["params"]["segmenter"]
    assert all(np.abs(g).max() == 0 for k, sub in seg.items() if k != "void_embedding"
               for g in jax.tree_util.tree_leaves(sub))
    tx = jax_build_optimizer(cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = jax.jit(tx.update)(jax.tree_util.tree_map(jnp.asarray, grads), tx.init(jparams), jparams)
    moved = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, updates["params"])})
    assert any(k.startswith("sem_seg_head.") and v.abs().max() > 0 for k, v in moved.items())
    port = _port(cfg, params)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    train_step, init = build_train_step(cfg, port, [_classifier()])
    state, _ = train_step(init(), _torch_batch(), _step_draws(cfg, 0, "dvis_online_ov"))
    assert not any(n.startswith("sem_seg_head.") for n in state.optimizer.params)
    sd = port.state_dict()
    assert all(torch.equal(sd[k], before[k]) for k in sd if k.startswith(("sem_seg_head.", "backbone.")))
    assert not torch.equal(sd["void_embedding.weight"], before["void_embedding.weight"])
