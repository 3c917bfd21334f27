"""The object-sharded refiner pass (``dvis_plus_tpu_torch/parallel/sp.py``)
against the JAX package's ``parallel/sp.py::refiner_embed_pass_sharded`` on
the conftest's CPU devices (a mesh of 4) and against the port's plain
``embed_pass``: Q = 10 objects over 4 shards (padded to 12), with and
without a time mask (T = 7 padded to 8 by replicating the last frame, as
the JAX eval loop buckets it), and with padded rows in ``instance_mask``.
Bars: rtol 2e-4, atol 2e-5 against the JAX sharded pass (as
``tests/test_multidevice.py``); 1e-6 against the port's plain pass. Then the
eval loop with ``test.refiner_shard_devices=3`` (8 queries over 3 shards)
writes the rows of the plain loop, and a count beyond the cards raises."""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.models.refiner.temporal_refiner import TemporalRefiner as JaxRefiner
from dvis_plus_tpu.parallel.mesh import build_mesh
from dvis_plus_tpu.parallel.sp import refiner_embed_pass_sharded as jax_sharded
from dvis_plus_tpu_torch import convert
from dvis_plus_tpu_torch.models.refiner.temporal_refiner import TemporalRefiner
from dvis_plus_tpu_torch.parallel.sp import refiner_embed_pass_sharded, shard_devices
from tests.test_torch_common import images, random_params, rel_err, tiny_cfg

torch.set_num_threads(2)

B, T, TB, Q, FQ, C, CM, K, SHARDS = 1, 7, 8, 10, 12, 32, 16, 3, 4
KW = dict(num_classes=K, hidden_dim=C, feedforward_dim=64, num_heads=2, num_layers=2, mask_dim=CM)


class _Wrap(fnn.Module):
    """A module owning a ``refiner``, as the JAX sharded pass expects."""

    def setup(self):
        self.refiner = JaxRefiner(**KW)

    def __call__(self, ie, fe):
        return self.refiner.embed_pass(ie, fe)


@functools.cache
def _models():
    wrap = _Wrap()
    shapes = jax.eval_shape(wrap.init, jax.random.key(0), jnp.zeros((B, 2, Q, C)), jnp.zeros((B, 2, FQ, C)))
    params = random_params(shapes, seed=4, scale=0.1)
    sd = {}
    convert._refiner(params["params"]["refiner"], sd)
    model = TemporalRefiner(**KW)
    model.load_state_dict({k[len("refiner."):]: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return wrap, params, model.eval()


def _inputs(time_masked):
    rng = np.random.RandomState(5)
    ie = rng.randn(B, T, Q, C).astype(np.float32)
    fe = rng.randn(B, T, FQ, C).astype(np.float32)
    if not time_masked:
        return ie, fe, None
    pad = lambda x: np.concatenate([x, np.repeat(x[:, -1:], TB - T, axis=1)], axis=1)  # noqa: E731
    return pad(ie), pad(fe), (np.arange(TB) < T)[None]


@pytest.mark.parametrize("time_masked", [False, True], ids=["whole", "time_masked"])
def test_sharded_pass_matches_jax_and_the_plain_pass(time_masked):
    wrap, params, model = _models()
    ie, fe, tm = _inputs(time_masked)
    mesh = build_mesh(jax.devices()[:SHARDS])
    want = jax.jit(lambda p, i, f, m: jax_sharded(wrap, p, i, f, mesh, time_mask=m))(
        params, jnp.asarray(ie), jnp.asarray(fe), None if tm is None else jnp.asarray(tm))
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    with torch.no_grad():
        got = refiner_embed_pass_sharded(model, t(ie), t(fe), [torch.device("cpu")] * SHARDS,
                                         time_mask=t(tm))
        plain = model.embed_pass(t(ie), t(fe), t(tm))
    assert sorted(got) == sorted(plain) == ["mask_embed", "pred_embds", "pred_logits"]
    for k in got:
        assert got[k].shape == plain[k].shape and got[k].shape[-2 if k == "pred_logits" else 2] == Q
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-4, atol=2e-5, err_msg=k)
        assert rel_err(got[k].numpy(), plain[k].numpy()) <= 1e-6, k


def test_padded_rows_are_masked_out_of_every_shard():
    """``instance_mask`` False on rows 3 and 9: the sharded pass equals the
    plain one, and the live rows do not see the masked ones."""
    _, _, model = _models()
    ie, fe, _ = _inputs(False)
    mask = torch.ones(B, Q, dtype=torch.bool)
    mask[:, [3, 9]] = False
    ie_t = torch.from_numpy(ie)
    with torch.no_grad():
        got = refiner_embed_pass_sharded(model, ie_t, torch.from_numpy(fe), [torch.device("cpu")] * SHARDS,
                                         instance_mask=mask)
        plain = model.embed_pass(ie_t, torch.from_numpy(fe), instance_mask=mask)
        moved = ie_t.clone()
        moved[:, :, [3, 9]] += 5.0  # what a masked row holds changes no live row
        other = refiner_embed_pass_sharded(model, moved, torch.from_numpy(fe), [torch.device("cpu")] * 3,
                                           instance_mask=mask)
    for k in got:
        assert rel_err(got[k].numpy(), plain[k].numpy()) <= 1e-6, k
    live = [q for q in range(Q) if q not in (3, 9)]
    assert rel_err(other["pred_logits"][:, live].numpy(), got["pred_logits"][:, live].numpy()) <= 1e-6


def _videos():
    for vid, (T_, out) in enumerate([(6, (48, 72)), (4, (64, 96))], 1):
        yield {"images": images(T_, seed=60 + vid), "image_size": np.asarray([56, 96]),
               "height": out[0], "width": out[1], "video_id": vid}


def _offline_rows(shards):
    from dvis_plus_tpu_torch.cli import build_model
    from dvis_plus_tpu_torch.engine.inference import run_vis_inference

    cfg = tiny_cfg()
    cfg.model.meta_architecture = "dvis_offline"
    cfg.model.refiner.num_layers, cfg.model.refiner.feedforward_dim, cfg.model.refiner.num_heads = 2, 64, 4
    cfg.test.refiner_shard_devices = shards
    torch.manual_seed(0)
    rows = []

    class Rows:
        def process(self, video_id, output):
            from dvis_plus_tpu_torch.evaluation.evaluators import YTVISEvaluator

            ev = YTVISEvaluator("synthetic", "unused")
            ev.process(video_id, output)
            rows.extend(ev.predictions)

    run_vis_inference(cfg, build_model(cfg.model).eval(), _videos(), Rows())
    return rows


def test_eval_loop_with_sharded_refiner_writes_the_plain_rows(monkeypatch):
    """DVIS++ offline's eval loop at ``test.refiner_shard_devices=3`` (the
    CPU three times; 8 queries padded to 9; one sharded pass a video)
    against the plain pass: the same rows, scores within 1e-5."""
    from dvis_plus_tpu_torch.parallel import sp

    calls, sharded = [], sp.refiner_embed_pass_sharded

    def counting(refiner, ie, fe, devices, **kw):
        calls.append(len(devices))
        return sharded(refiner, ie, fe, devices, **kw)

    want = _offline_rows(0)
    monkeypatch.setattr(sp, "refiner_embed_pass_sharded", counting)
    got = _offline_rows(3)
    assert calls == [3, 3]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["video_id"], g["category_id"], g["segmentations"]) == \
               (w["video_id"], w["category_id"], w["segmentations"])
        assert abs(g["score"] - w["score"]) <= 1e-5 * max(abs(w["score"]), 1e-6)


def test_more_shards_than_cards_raise(monkeypatch):
    """On the card the shards are cuda:0 .. n-1; fewer cards raise (nothing
    falls back to the plain pass)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="refiner_shard_devices=2"):
        shard_devices(2, torch.device("cuda", 0))
    assert shard_devices(3, torch.device("cpu")) == [torch.device("cpu")] * 3
