"""Data-parallel training of OV-DVIS++ online (the tracker and the set's
void row on the segmenter) in two spawned gloo ranks, one clip a rank
(``tests/torch_ddp.py``; one spawn), at the bars of
``tests/test_torch_distributed.py``.

- Against the JAX ``build_train_step`` over the global batch of 2 clips
  (``tests/test_torch_ov_train.py``'s tiny ConvNeXt model, its text
  classifier and void row 0; two steps).
- A mixture of two training sets (two void rows, 5 classes of 3 templates
  and 3 of 2), a batch of set 0 then one of set 1, with the port's own
  draws, against the port's one-process steps: the batch's
  ``dataset_index`` routes every rank alike, and the void row of the set
  not trained gets no gradient on any rank, which the reduction counts as
  zero (as the optimizer does).
"""
import copy

import numpy as np
import pytest
import torch

from dvis_plus_tpu_torch.convert import state_dict_from_jax
from tests import test_torch_ov_train as ov_train
from tests import torch_ddp
from tests.test_torch_common import ov_text_classifier
from tests.test_torch_distributed import check_ranks
from tests.test_torch_minvis_train import _batch as clips_batch

torch.set_num_threads(2)
ARCH = "dvis_online_ov"
TC1_TEMPLATES = (2, 2, 2, 1)


def _mixture(cfg, params):
    """(configuration, weights, the two sets' classifiers) of the mixture."""
    cfg = copy.deepcopy(cfg)
    cfg.model.ov.num_void_embeddings = 2
    sd = state_dict_from_jax(params)
    sd["additional_void_embedding.weight"] = torch.from_numpy(
        np.random.RandomState(1).randn(*sd["void_embedding.weight"].shape).astype(np.float32))
    tc0, nt0, _ = ov_text_classifier()
    tc1 = np.random.RandomState(9).randn(6, tc0.shape[1]).astype(np.float32)
    return cfg, sd, [(tc0, nt0, 0), (tc1, TC1_TEMPLATES, 1)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg, _, params = ov_train._cfg(ARCH)
    tc, nt, _ = ov_text_classifier()
    batch = torch_ddp.raw_batch(*clips_batch())
    mcfg, msd, sets = _mixture(cfg, params)
    x, labels, masks, valid, fv = clips_batch(seed=4)
    set1 = torch_ddp.raw_batch(x, labels % (len(TC1_TEMPLATES) - 1), masks, valid, fv, dataset_index=1)
    cases = {
        "jax": dict(cfg=torch_ddp.namespace(cfg), state_dict=state_dict_from_jax(params), batches=[batch] * 2,
                    draws=[ov_train._step_draws(cfg, s, ARCH).table for s in range(2)], ov=True,
                    classifiers=[(tc, nt, 0)]),
        "mixture": dict(cfg=torch_ddp.namespace(mcfg), state_dict=msd, batches=[batch, set1], ov=True,
                        classifiers=sets),
    }
    spawned = torch_ddp.spawn("train_runs", list(cases.values()), tmp_path_factory.mktemp("ddp_ov"),
                              wait=False)
    jax_steps = ov_train._jax_steps(ARCH)
    alone = torch_ddp.run(**cases["mixture"])
    ranks = spawned.results()
    return [r[0] for r in ranks], [r[1] for r in ranks], jax_steps, alone


def test_two_rank_step_matches_the_jax_global_batch_step(runs):
    got, _, (metrics, grads, after), _ = runs
    trained = sorted(got[0]["params"])
    assert {n.split(".")[0] for n in trained} == {"tracker", "void_embedding"}
    jg, ja = state_dict_from_jax({"params": grads["params"]}), state_dict_from_jax(after)
    check_ranks(got, metrics, {n: jg[n].numpy() for n in trained}, {n: ja[n].numpy() for n in trained},
                trained)


def test_two_rank_mixture_equals_the_one_process_steps(runs):
    _, mixed, _, alone = runs
    trained = sorted(alone["params"])
    assert "additional_void_embedding.weight" in trained
    check_ranks(mixed, alone["metrics"], alone["grads"][0], alone["params"], trained)
    for rank in mixed:
        for step, (own, other) in enumerate((("void_embedding.weight", "additional_void_embedding.weight"),
                                             ("additional_void_embedding.weight", "void_embedding.weight"))):
            assert np.abs(rank["grads"][step][own]).max() > 0, step
            assert not rank["grads"][step][other].any(), step
        assert torch_ddp.norm_gap([rank["grads"][1][n] for n in trained],
                                  [alone["grads"][1][n] for n in trained]) <= 1e-4
