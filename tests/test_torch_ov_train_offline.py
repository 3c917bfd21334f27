"""DVIS++ OV offline training (the refiner on the frozen online model)
against the JAX package: the step at the bars of
``tests/test_torch_ov_train.py`` (one JAX executable), and finding 1 of that
file's docstring: under ``freeze: [backbone, segmenter, tracker]`` the void
rows stay fixed, as the JAX step leaves them."""
import numpy as np
import torch

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


def test_dvis_offline_ov_train_step_matches_jax():
    """The refiner trains; the online model, the void rows among it, stays
    fixed."""
    check_train_step_matches_jax("dvis_offline_ov")


def test_offline_void_rows_stay_fixed_as_in_jax():
    """``freeze: [backbone, segmenter, tracker]``: the refiner scores
    against the classifier with void row 0, which would carry its gradient;
    both packages keep the row where it was."""
    cfg, _, params = _cfg("dvis_offline_ov")
    _, grads, after_params = _jax_steps("dvis_offline_ov")
    jg = np.asarray(grads["params"]["online"]["segmenter"]["void_embedding"])
    assert np.abs(jg).max() > 0  # the JAX loss reaches the row; its optimizer masks it
    want = np.asarray(params["params"]["online"]["segmenter"]["void_embedding"])
    assert np.array_equal(after_params["params"]["online"]["segmenter"]["void_embedding"], want)
    port = _port(cfg, params)
    train_step, init = build_train_step(cfg, port, [_classifier()])
    train_step(init(), _torch_batch(), _step_draws(cfg, 0, "dvis_offline_ov"))
    assert not port.void_embedding.weight.requires_grad
    assert np.array_equal(port.void_embedding.weight.detach().numpy(), want)
