"""A run over a broken timed path comes out not correct, by the cell's own limits.

The harness's look for a card is skipped (``eval_stream`` runs on the CPU at tiny
widths); the rest of a run is driven as the benchmark drives it, with the
fault planted in the program underneath. The faults an eval cell can have: a
step that returns its state unchanged (the tracker's carry), half of the batch
left out and the mean taken over the rest (the frames of each window), an
answer altered where it is produced (an object's class logits, as the refiner
makes them; the class maps, as the post-processing makes them: frames out of
order, or the map moved off its pixels as a wrong resize or crop would). The
exchange between chips does not exist in a one-chip cell.
"""
from __future__ import annotations

import json
import os

import pytest

from port_bench.bench import registry
from port_bench.drivers import eval_stream
from port_bench.tests import common


def cell_limits():
    with open(os.path.join(registry.BENCH, "limits", f"{common.CELL}.json")) as f:
        return json.load(f)["limits"]


def state_unchanged(model):
    """The tracker's recurrent step hands on the state it was given."""
    step = model.tracker.frame_step
    model.tracker.frame_step = lambda state, *a, **k: (*step(state, *a, **k)[:3], state)


def half_batch(model):
    def pre(m, args):
        x = args[0].clone()
        k = (x.shape[0] + 1) // 2
        x[k:] = x[:k].mean(dim=0, keepdim=True)
        return (x,) + tuple(args[1:])

    model.backbone.register_forward_pre_hook(pre)


def altered_answer(model):
    """The refiner's class answer for one object (query 0) altered where the
    refiner produces it: its class logits rolled by one class. (The class
    maps that follow from it have no compared number of their own: their
    near-ties swing whole regions, ``PERF.md``.)"""
    embed_pass = model.refiner.embed_pass

    def altered(*a, **k):
        out = dict(embed_pass(*a, **k))
        logits = out["pred_logits"].clone()
        logits[:, 0] = logits[:, 0].roll(1, dims=-1)
        out["pred_logits"] = logits
        return out

    model.refiner.embed_pass = altered


def post_frame_order(out):
    """Each time chunk's class maps in reverse frame order."""
    return out.flip(0)


def post_shifted(out):
    """The class maps moved four pixels to the right, as an off-grid resize or crop would."""
    return out.roll(4, dims=-1)


def test_the_sound_program_passes(tmp_path):
    r = eval_stream.run(common.ctx(tmp_path, limits=cell_limits()))
    assert r.correct, r.checks


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_a_fault_is_not_correct(tmp_path, fault):
    tamper = {"state_unchanged": state_unchanged, "half_batch": half_batch,
              "answer_altered": altered_answer}[fault]
    r = eval_stream.run(common.ctx(tmp_path, limits=cell_limits(), tamper=tamper))
    assert not r.correct, r.checks
    assert any(c["value"] > c["limit"] for c in r.checks.values())


@pytest.mark.parametrize("fault", ["frame_order", "shifted"])
def test_a_post_processing_fault_is_not_correct(tmp_path, monkeypatch, fault):
    """The fault planted in the program's ``semantic_inference``, after the
    mask logits that reach it are taken."""
    import dvis_plus_tpu_torch.engine.inference as inf

    alter = {"frame_order": post_frame_order, "shifted": post_shifted}[fault]
    sem = inf.semantic_inference
    monkeypatch.setattr(inf, "semantic_inference", lambda *a, **k: alter(sem(*a, **k)))
    r = eval_stream.run(common.ctx(tmp_path, limits=cell_limits()))
    assert not r.correct, r.checks
    assert any(c["value"] > c["limit"] for c in r.checks.values())
