"""Data-parallel training of DVIS-DAQ online (the cutter, stage 3) in two
spawned gloo ranks, one clip a rank (``tests/torch_ddp.py``; one spawn), at
the bars of ``tests/test_torch_distributed.py``.

The JAX step trains the first clip of its batch alone
(``tests/test_torch_daq_train.py::test_jax_step_trains_the_first_clip_alone``),
so the global batch is held clip by clip, as the reference's one clip a
GPU gives it: each loss the mean over the clips of the JAX step's over that
clip alone, its mask losses scaled from the clip's own matched count to
the batch's mean (``shared_count``, all-reduced over the ranks); the
gradients and parameters against the port's one-process step with the same
JAX draws (each clip's answered under ``("clip", b)``, b the clip's place
in the whole batch). With the port's own draws (a clip's from a generator
of its own, ``utils.draws.clip_draws``) against the port's one-process step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.engine.trainer import Batch as JaxBatch
from dvis_plus_tpu_torch.convert import state_dict_from_jax
from dvis_plus_tpu_torch.engine import trainer as ptrain
from dvis_plus_tpu_torch.engine.trainer import Batch
from tests import test_torch_daq_train as daq_train
from tests import torch_ddp
from tests.test_torch_common import JaxDraws, nchw, rel_err
from tests.test_torch_distributed import BARS, check_ranks

torch.set_num_threads(2)
SWITCH = 0  # stage 3 from step 0, in both packages


def _clips():
    return [daq_train._clip(3), daq_train._clip(4)]


def _batch(clips):
    return torch_ddp.raw_batch(np.stack([x for x, _ in clips]), *daq_train.batched(*(t for _, t in clips)))


def _jax(cfg, params, clips):
    """Each clip's JAX step alone (its own key) and the draws table of the
    batch (clip b's under ``("clip", b)``)."""
    step_fn, init_state = daq_train._jax_step_fn(SWITCH)
    want, table = [], {}
    for b, (x, tg) in enumerate(clips):
        _, m = step_fn(init_state(jax.tree_util.tree_map(jnp.asarray, params)),
                       JaxBatch(images=jnp.asarray(x)[None], targets=daq_train.jax_targets(*daq_train.batched(tg))),
                       jax.random.key(40 + b))
        want.append({k: np.asarray(v) for k, v in m.items() if k not in ("total_loss", "grad_norm")})
        r1, r2 = jax.random.split(jax.random.fold_in(jax.random.key(40 + b), 0))
        table.update(daq_train.online_draws(r1, r2, cfg, clip=b))
    return want, table


def _counts(cfg, clips, table):
    """The clips' matched counts by branch, from the port's forward over the
    batch with the JAX draws."""
    pm, log = daq_train.port_daq(SWITCH), []
    ptrain.set_modes(pm)
    daq_train.recording_forward(pm, log)
    batch = Batch(torch.stack([nchw(x) for x, _ in clips]),
                  daq_train.port_targets(*daq_train.batched(*(t for _, t in clips))))
    with torch.no_grad():
        ptrain.build_loss_fn(cfg, pm)(batch, JaxDraws(table), 0, None)
    return daq_train.matched_counts(log[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg, _, params = daq_train._setup(SWITCH)
    clips = _clips()
    want, table = _jax(cfg, params, clips)
    ns, sd, batch = torch_ddp.namespace(cfg), state_dict_from_jax(params), _batch(clips)
    cases = {
        "jax": dict(cfg=ns, state_dict=sd, batches=[batch], draws=[table]),
        "own": dict(cfg=ns, state_dict=sd, batches=[batch, _batch([daq_train._clip(5), clips[0]])]),
    }
    spawned = torch_ddp.spawn("train_runs", list(cases.values()), tmp_path_factory.mktemp("ddp_daq"),
                              wait=False)
    counts = _counts(cfg, clips, table)
    alone = {k: torch_ddp.run(**v) for k, v in cases.items()}
    ranks = spawned.results()
    return {k: [r[i] for r in ranks] for i, k in enumerate(cases)}, alone, (want, counts)


@pytest.mark.parametrize("case", ["own", "jax"])
def test_two_rank_step_equals_the_one_process_step(runs, case):
    by_case, alone, _ = runs
    want = alone[case]
    check_ranks(by_case[case], want["metrics"], want["grads"][0], want["params"], sorted(want["params"]))


def test_two_rank_step_is_the_mean_of_the_jax_clips(runs):
    """Each loss of the two-rank step against the JAX step over each clip
    alone: the mean over the clips, the mask and dice losses scaled by the
    clip's matched count over the batch's mean (the counts differ, so the
    all-reduced divisor shows)."""
    by_case, _, (want, counts) = runs
    assert all(len(set(c)) == len(c) for c in counts.values()), counts
    got = by_case["jax"]
    assert sorted(k for k in got[0]["metrics"][0] if k not in ("total_loss", "grad_norm")) == sorted(want[0])
    for k in want[0]:
        group = daq_train.divisor_group(k)
        f = np.ones(len(want)) if group is None else daq_train.shared_factors(counts[group])
        expected = sum(w[k] * fb for w, fb in zip(want, f)) / len(want)
        for rank in got:
            assert rel_err(rank["metrics"][0][k], expected) <= BARS["loss"], k
