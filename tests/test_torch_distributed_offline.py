"""Data-parallel training of DVIS++ offline (stage 3 of the recipe: the
refiner on the frozen online model, with the class memory) in two spawned
gloo ranks, one clip a rank (``tests/torch_ddp.py``; one spawn), at the
bars of ``tests/test_torch_distributed.py``: against the JAX
``build_train_step`` over the global batch of 2 clips
(``tests/test_torch_offline_train.py``'s tiny model and two steps), the
losses, step 0's gradients, the parameters after, and the class memory
after two steps (the counts equal, the embeddings rel <= 1e-5), every rank
pushing the whole batch's embeddings in its order, so that the two ranks'
memories are equal bit for bit; and with the port's own draws against the
port's one-process step.
"""
import numpy as np
import pytest
import torch

from dvis_plus_tpu_torch.convert import state_dict_from_jax
from tests import test_torch_offline_train as offline_train
from tests import torch_ddp
from tests.test_torch_common import rel_err
from tests.test_torch_distributed import BARS, check_ranks
from tests.test_torch_minvis_train import _batch as clips_batch

torch.set_num_threads(2)


def _batch(seed=3):
    x, labels, masks, valid, fv = clips_batch(seed=seed)
    return torch_ddp.raw_batch(x, labels % offline_train.K, masks, valid, fv)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg, _, params = offline_train._jax_model()
    ns, sd, batch = torch_ddp.namespace(cfg), state_dict_from_jax(params), _batch()
    cases = {
        "jax": dict(cfg=ns, state_dict=sd, batches=[batch, batch],
                    draws=[offline_train._step_draws(cfg, s).table for s in range(2)]),
        "own": dict(cfg=ns, state_dict=sd, batches=[batch, _batch(seed=9)]),
    }
    spawned = torch_ddp.spawn("train_runs", list(cases.values()), tmp_path_factory.mktemp("ddp_offline"),
                              wait=False)
    jax_steps = offline_train._jax_steps()
    alone = torch_ddp.run(**cases["own"])
    ranks = spawned.results()
    return {k: [r[i] for r in ranks] for i, k in enumerate(cases)}, alone, jax_steps


def test_two_rank_step_matches_the_jax_global_batch_step(runs):
    by_case, _, (metrics, grads, after, want_mem) = runs
    ranks = by_case["jax"]
    trained = sorted(ranks[0]["params"])
    assert trained and all(n.startswith("refiner.") for n in trained)
    jg, ja = state_dict_from_jax({"params": grads["params"]}), state_dict_from_jax(after)
    check_ranks(ranks, metrics, {n: jg[n].numpy() for n in trained}, {n: ja[n].numpy() for n in trained},
                trained)
    for got in ranks:
        assert np.array_equal(got["memory"]["count"], np.asarray(want_mem.count))
        assert int(got["memory"]["count"].sum()) > 0
        assert rel_err(got["memory"]["embeds"], np.asarray(want_mem.embeds)) <= BARS["loss"]
    for k in ("count", "embeds"):
        assert np.array_equal(ranks[0]["memory"][k], ranks[1]["memory"][k]), k


def test_two_rank_step_equals_the_one_process_step(runs):
    by_case, want, _ = runs
    check_ranks(by_case["own"], want["metrics"], want["grads"][0], want["params"], sorted(want["params"]))
    for got in by_case["own"]:
        assert np.array_equal(got["memory"]["count"], want["memory"]["count"])
        assert rel_err(got["memory"]["embeds"], want["memory"]["embeds"]) <= BARS["loss"]
