"""Data-parallel training of the port (``parallel/mesh.py``,
``engine/trainer.py::build_train_step`` under a process group,
``cli.py::do_train``) in two spawned gloo ranks on the CPU, one clip a rank
(``tests/torch_ddp.py``; one spawn runs every case of this file in turn).

The rule, as ``tests/test_multidevice.py`` holds it of the JAX mesh: a
step at world size 2 equals the one-process step over the whole batch.

- Against the JAX ``build_train_step`` over the global batch of 2 clips,
  the JAX draws answered by site to each rank for its clip
  (``utils.draws.BlockDraws``): MinVIS (the backbone frozen on both sides,
  as ``tests/test_torch_minvis_train.py`` holds its two-step update) and
  DVIS++ online (the segmenter frozen, as its YAML). Two steps; bars: every
  loss rel <= 1e-5, step 0's gradients of the trained parameters within
  1e-4 as a norm, the parameters after within 1e-5 as a norm; the ranks'
  parameters equal bit for bit.
- With the port's own draws, the same families against the port's
  one-process step, at the same bars.
- ``parallel.model_parallel_size=2`` at world size 2 (both ranks one model
  group: the whole batch each) and 3 clips over 2 ranks (replicated) equal
  the one-process step bit for bit.
- The CLI in two ranks: DVIS++ offline (its class memory) 4 steps
  unbroken, and 2 steps then ``--resume`` to 4, end bit-equal; rank 0
  alone writes the checkpoints and ``metrics.jsonl``; and the 2-rank run
  ends within 1e-5 of the one-process CLI run (each rank maps its block of
  the one-process loader's batches).
- The pieces in one process: each rank's block of a batch
  (``parallel.mesh.batch_block``), a rank's draws as the rows of the whole
  batch's (``utils.draws.BlockDraws``, a clip's generator of its own), and
  a rank's loader mapping its block of the one-process loader's batches.
"""
import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dvis_plus_tpu.engine.trainer import Batch as JaxBatch
from dvis_plus_tpu.engine.trainer import build_optimizer as jax_build_optimizer
from dvis_plus_tpu.engine.trainer import build_train_step as jax_build_train_step
from dvis_plus_tpu.losses.targets import VideoTargets as JaxTargets
from dvis_plus_tpu_torch.config import TINY_TRAIN
from dvis_plus_tpu_torch.convert import state_dict_from_jax
from tests import test_torch_minvis_train as minvis_train
from tests import test_torch_train as online_train
from tests import torch_ddp
from tests.test_torch_common import rel_err

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from synth_data import make_ytvis  # noqa: E402

torch.set_num_threads(2)
BARS = {"loss": 1e-5, "grad": 1e-4, "param": 1e-5}


def _minvis():
    cfg, _, params = minvis_train._cfg("minvis")
    cfg = copy.deepcopy(cfg)
    cfg.model.freeze = ("backbone",)
    return cfg, params


def _online():
    cfg, _, params = online_train._cfg()
    return cfg, params


def _batch(*arrays, B=2):
    """A batch of the first B clips of the batches ``arrays``."""
    return torch_ddp.raw_batch(*(np.concatenate(a)[:B] for a in zip(*arrays)))


def _jax_online_steps(cfg, params, arrays):
    """Two JAX steps of DVIS++ online over the global batch (the package's
    optimizer, a first stage keeping the raw gradients)."""
    _, model, _ = online_train._cfg()
    x, labels, masks, valid, fv = arrays
    jbatch = JaxBatch(images=jnp.asarray(x), targets=JaxTargets(
        labels=jnp.asarray(labels), masks=jnp.asarray(masks), valid=jnp.asarray(valid),
        frame_valid=jnp.asarray(fv)))
    step_fn, init_state = jax_build_train_step(cfg, model, optimizer=optax.chain(
        minvis_train._capture(), jax_build_optimizer(cfg)))
    state = init_state(jax.tree_util.tree_map(jnp.asarray, params))
    metrics, grads = [], None
    for step in range(2):
        state, m = step_fn(state, jbatch, jax.random.key(cfg.seed))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
        if step == 0:
            grads = jax.tree_util.tree_map(np.asarray, state.opt_state[0])
    return metrics, grads, jax.tree_util.tree_map(np.asarray, state.params)


DATA = ["input.sampling_frame_num=3", "input.min_size_train=[48,64]", "input.max_size_train=96",
        "model.criterion.max_num_instances=3", "solver.ims_per_batch=2"]
CLI_TINY = [*TINY_TRAIN, "model.tracker.matcher_solver=jv", "model.criterion.train_num_points=64",
            "solver.checkpoint_period=2", *DATA]


def _cli_argv(out, steps, resume=False):
    return ["--config-file", "configs/dvis/dvis_offline_r50_ytvis19.yaml", "--device", "cpu",
            *(["--resume"] if resume else []), *CLI_TINY, f"solver.max_iter={steps}", f"output_dir={out}"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawn's results by case (a list of the two ranks'), the
    one-process runs, the JAX steps, and the CLI runs' directory."""
    from dvis_plus_tpu.data.datasets.categories import YTVIS_2019_CLASSES

    tmp = tmp_path_factory.mktemp("ddp")
    data = str(tmp / "data")
    make_ytvis(data, "ytvis_2019", YTVIS_2019_CLASSES, n_videos=3, length=6)
    (mcfg, mparams), (ocfg, oparams) = _minvis(), _online()
    marrays, oarrays = minvis_train._batch(), online_train._batch()
    msd, osd = state_dict_from_jax(mparams), state_dict_from_jax(oparams)
    nm, no = torch_ddp.namespace(mcfg), torch_ddp.namespace(ocfg)
    mb, ob = _batch(marrays), _batch(oarrays)
    ob2 = _batch(online_train._batch(seed=8))
    cases = {
        "minvis_jax": dict(cfg=nm, state_dict=msd, batches=[mb, mb],
                           draws=[minvis_train.step_draws(mcfg, s, "minvis").table for s in range(2)]),
        "online_jax": dict(cfg=no, state_dict=osd, batches=[ob, ob],
                           draws=[online_train._step_draws(ocfg, s).table for s in range(2)]),
        "minvis_own": dict(cfg=nm, state_dict=msd, batches=[mb, _batch(minvis_train._batch(seed=9))]),
        "online_own": dict(cfg=no, state_dict=osd, batches=[ob, ob2]),
        "minvis_model_parallel": dict(cfg=nm, state_dict=msd, batches=[mb], model_parallel_size=2),
        "online_3_clips": dict(cfg=no, state_dict=osd,
                               batches=[_batch(oarrays, online_train._batch(seed=8), B=3)]),
    }
    # the broken run stops after step 2: its checkpoint of step 4 is removed
    cli = {"data": data, "argv": [_cli_argv(tmp / "unbroken", 4), _cli_argv(tmp / "broken", 4),
                                  str(tmp / "broken" / "checkpoints" / "step_0000004.pth"),
                                  _cli_argv(tmp / "broken", 4, resume=True)]}
    spawned = torch_ddp.spawn("several", [("train_runs", list(cases.values())), ("cli_train_ranks", cli)],
                              tmp, wait=False)
    jax_steps = {"minvis_jax": minvis_train._jax_steps("minvis"),
                 "online_jax": _jax_online_steps(ocfg, oparams, oarrays)}
    alone = {k: torch_ddp.run(**{**v, "model_parallel_size": 1}) for k, v in cases.items()
             if not k.endswith("_jax")}
    os.environ["DVIS_DATASETS"] = data
    from dvis_plus_tpu_torch import cli as port_cli

    port_cli.main(_cli_argv(tmp / "one_process", 4))
    ranks = spawned.results()
    by_case = {k: [r[0][i] for r in ranks] for i, k in enumerate(cases)}
    return by_case, alone, jax_steps, [r[1] for r in ranks], tmp


def check_ranks(ranks, want_metrics, want_grads, want_params, trained):
    """Both ranks against a reference at :data:`BARS`: each step's losses,
    step 0's gradients, the parameters after; the ranks equal."""
    for got in ranks:
        assert sorted(got["grads"][0]) == sorted(trained) and trained
        for step, want in enumerate(want_metrics):
            for k in want:
                assert rel_err(got["metrics"][step][k], want[k]) <= BARS["loss"], (step, k)
        assert torch_ddp.norm_gap([got["grads"][0][n] for n in trained],
                                  [want_grads[n] for n in trained]) <= BARS["grad"]
        assert torch_ddp.norm_gap([got["params"][n] for n in trained],
                                  [want_params[n] for n in trained]) <= BARS["param"]
    for n in trained:
        assert np.array_equal(ranks[0]["params"][n], ranks[1]["params"][n]), n


@pytest.mark.parametrize("case,prefix", [("minvis_jax", "sem_seg_head."), ("online_jax", "tracker.")])
def test_two_rank_step_matches_the_jax_global_batch_step(runs, case, prefix):
    by_case, _, jax_steps, _, _ = runs
    metrics, grads, after = jax_steps[case][0], jax_steps[case][1], jax_steps[case][-1]
    trained = sorted(by_case[case][0]["params"])
    assert all(n.startswith(prefix) for n in trained)
    jg = state_dict_from_jax({"params": grads["params"]})
    want_after = state_dict_from_jax(after if "params" in after else {"params": after})
    check_ranks(by_case[case], [{k: v for k, v in m.items() if k != "grad_norm"} for m in metrics],
           {n: jg[n].numpy() for n in trained}, {n: want_after[n].numpy() for n in trained}, trained)
    assert {k for k in by_case[case][0]["metrics"][0] if k != "grad_norm"} == set(metrics[0]) - {"grad_norm"}


@pytest.mark.parametrize("case", ["minvis_own", "online_own"])
def test_two_rank_step_equals_the_one_process_step(runs, case):
    by_case, alone, _, _, _ = runs
    want = alone[case]
    trained = sorted(want["params"])
    check_ranks(by_case[case], want["metrics"], want["grads"][0], want["params"], trained)
    for got in by_case[case]:
        assert torch_ddp.norm_gap([got["grads"][1][n] for n in trained],
                                  [want["grads"][1][n] for n in trained]) <= BARS["grad"]


@pytest.mark.parametrize("case", ["minvis_model_parallel", "online_3_clips"])
def test_replicated_steps_equal_the_one_process_step_bit_for_bit(runs, case):
    """A model group of two ranks, and a batch of 3 clips that does not
    divide over 2 ranks: every rank takes the whole batch."""
    by_case, alone, _, _, _ = runs
    want = alone[case]
    for got in by_case[case]:
        assert got["metrics"] == want["metrics"]
        for n in want["params"]:
            assert np.array_equal(got["params"][n], want["params"][n]), n
            assert np.array_equal(got["grads"][0][n], want["grads"][0][n]), n


def test_two_rank_cli_resumes_bit_equal_and_rank_0_writes(runs):
    from dvis_plus_tpu_torch.core import checkpoint as ckpt

    _, _, _, cli, tmp = runs
    assert [r["steps"] for r in cli] == [[4, 4, 4]] * 2
    names = ["step_0000002.pth", "step_0000004.pth"]
    # unbroken: steps 2 and 4; broken: the same, then resumed from 2, step 4
    assert [os.path.basename(p) for p in cli[0]["saves"]] == names * 2 + names[1:]
    assert cli[1]["saves"] == []
    for run in ("unbroken", "broken"):
        assert sorted(os.listdir(tmp / run / "checkpoints")) == names
        with open(tmp / run / "metrics.jsonl") as f:  # step 0 of a run started at 0, by rank 0
            assert [json.loads(line)["step"] for line in f] == [0]
    a, b = (ckpt.restore(str(tmp / run / "checkpoints" / names[1])) for run in ("unbroken", "broken"))
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for part in ("mu", "nu"):
        for k in a["optimizer"][part]:
            assert torch.equal(a["optimizer"][part][k], b["optimizer"][part][k]), k
    for k in a["memory"]:
        assert torch.equal(a["memory"][k], b["memory"][k]), k
    assert int(a["memory"]["count"].sum()) > 0
    one = ckpt.restore(str(tmp / "one_process" / "checkpoints" / names[1]))
    trained = [k for k in a["model"] if k.startswith("refiner.")]
    assert torch_ddp.norm_gap([a["model"][k].numpy() for k in trained],
                              [one["model"][k].numpy() for k in trained]) <= BARS["param"]
    assert torch.equal(a["memory"]["count"], one["memory"]["count"])


# ---------------------------------------------------------------------------
# the pieces, in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total,world_size,mp,want", [
    (8, 2, 1, [(0, 4, 8, True), (4, 4, 8, True)]),
    (8, 4, 2, [(0, 4, 8, True), (0, 4, 8, False), (4, 4, 8, True), (4, 4, 8, False)]),
    (3, 2, 1, [(0, 3, 3, True), (0, 3, 3, False)]),  # 3 clips do not divide: replicated
    (2, 2, 2, [(0, 2, 2, True), (0, 2, 2, False)]),  # one model group: the whole batch each
])
def test_batch_blocks(total, world_size, mp, want):
    from dvis_plus_tpu_torch.parallel.mesh import batch_block

    assert [tuple(batch_block(total, r, world_size, mp)) for r in range(world_size)] == want


def test_model_group_must_divide_the_world():
    from dvis_plus_tpu_torch.parallel.mesh import batch_block

    with pytest.raises(ValueError, match="model_parallel_size=3"):
        batch_block(8, 0, 4, 3)


def test_block_draws_are_the_whole_batch_draws_rows():
    """A rank's draws are its rows of the one process's; clip b of the block
    draws as clip start + b of the batch, from a generator of its own."""
    from dvis_plus_tpu_torch.utils.draws import BlockDraws, Draws, step_generator

    def whole():
        return Draws(step_generator(3, 5, torch.device("cpu")))

    want = whole()
    u, p, i = want.uniform(("u",), (8 * 3, 2)), want.permutation(("p",), 8, 6), want.randint(("i",), 0, 9, (8, 2))
    clip = want.for_clip(5).uniform(("c",), (4,))
    assert not torch.equal(want.for_clip(5).uniform(("c",), (4,)), clip)  # one stream a clip, drawn on
    assert torch.equal(whole().for_clip(5).uniform(("c",), (4,)), clip)
    got = BlockDraws(whole(), 4, 2, 8)
    assert torch.equal(got.uniform(("u",), (2 * 3, 2)), u[12:18])
    assert torch.equal(got.permutation(("p",), 2, 6), p[4:6])
    assert torch.equal(got.randint(("i",), 0, 9, (2, 2)), i[4:6])
    assert torch.equal(got.for_clip(1).uniform(("c",), (4,)), clip)
    with pytest.raises(ValueError, match="3 rows over a block of 2"):
        got.uniform(("x",), (3,))


@pytest.mark.parametrize("start_batches", [0, 2])
def test_a_ranks_loader_maps_its_block_of_the_whole_batch(tmp_path, start_batches):
    from dvis_plus_tpu.data.datasets.categories import YTVIS_2019_CLASSES
    from dvis_plus_tpu_torch.config import load_config
    from dvis_plus_tpu_torch.data.build import build_combined_train_loader
    from dvis_plus_tpu_torch.data.datasets.ytvis import register_all_ytvis

    make_ytvis(str(tmp_path), "ytvis_2019", YTVIS_2019_CLASSES, n_videos=3, length=6)
    register_all_ytvis(str(tmp_path))
    cfg = load_config("configs/dvis/dvis_online_r50_ytvis19.yaml", DATA[:3] + [
        "solver.ims_per_batch=4", "datasets.train=[ytvis_2019_train,ytvis_2019_train]",
        "datasets.dataset_ratio=[1.0,2.0]"])
    whole = build_combined_train_loader(cfg, seed=4, start_batches=start_batches, num_workers=0)
    ranks = [build_combined_train_loader(cfg, seed=4, start_batches=start_batches, num_workers=2,
                                         block=(2 * r, 2)) for r in range(2)]
    for _ in range(3):
        w, parts = next(whole), [next(r) for r in ranks]
        for k in ("images", "labels", "masks", "valid", "frame_valid"):
            np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), w[k], err_msg=k)
        assert {p["dataset_index"] for p in parts} == {w["dataset_index"]}
