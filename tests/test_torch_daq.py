"""The port's DVIS-DAQ modules against the JAX package's (fp32, tiny
widths, seeded weights shaped like the JAX trees and converted with
``convert.state_dict_from_jax``):

- the slot cross-attention layer (dead table rows masked), rel <= 1e-5;
- ``sgff_update`` over counts that wrap the ring of 10, <= 1e-6;
- the slot-to-query assignment on both of its branches, and the auction on
  a DAQ-shaped cost (55 rows, the dead ones tied, 100 columns), equal to
  the JAX auction whatever the check schedule;
- ``inference_step`` over 7 frames: the integer slot state (``alive``,
  ``seq_id``, ``invalid_frames``) equal at every frame, slot logits and
  masks rel <= 1e-4 (the recurrent-tracker bar of PARITY.md). Every score
  compared with a threshold, and every mask logit thresholded, is asserted
  to lie more than 1e-4 from it, so a difference is a fault, not a
  rounding; the port's window loop equals its frame steps;
- ``stream_video`` + ``collect_sequences`` over two windows of 4 frames:
  the same sequences, frames and rows, with the run asserted to cover the
  bookkeeping (a sequence started after frame 0, a track kept through a
  missed frame, a kick-out, a sequence dropped as noise);
- the offline refiner pass with fewer sequences than ``offline_topk_num``
  (the padded rows masked out of the object attention), rel <= 1e-4, and
  ``_offline_refine`` end to end;
- ``_vos_output``'s PNGs against the JAX function's (OpenCV resizes there,
  torch here), pixel for pixel.

The cutter's class head is scaled (x8) so that some queries pass the
selection threshold and some do not, and so that the 7 frames of the
stream test hold every bookkeeping event with a table of 6 slots; the mask
heads (x10 a layer) so that mask logits are of a trained model's order (the
eval loop rounds them to fp16)."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (
    DAQ_C,
    DAQ_FQ,
    DAQ_K,
    DAQ_NS,
    DAQ_QC,
    H_IN,
    W_IN,
    jax_daq_model_and_params as models,
    rel_err,
    on_card_canvas,
    tiny_daq_cfg as daq_cfg,
)

torch.set_num_threads(2)

T = 7
K, FQ, QC, NS, C = DAQ_K, DAQ_FQ, DAQ_QC, DAQ_NS, DAQ_C
MARGIN = 1e-4  # least distance of a thresholded value from its threshold
TOL = 1e-4


def video(seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).randn(T, H_IN, W_IN, 3).astype(np.float32)


def _jax_cutter(jm, fn):
    """A method of the JAX cutter, through ``apply``."""
    def call(mdl, *args, **kwargs):
        cutter = mdl.online.cutter if hasattr(mdl, "online") else mdl.cutter
        return fn(cutter, *args, **kwargs)
    return call


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_fp16_close(got, want):
    """fp16-rounded mask logits (the eval loop's) within rel ``TOL`` of the
    largest logit plus one fp16 unit of the value: the fp32 values they
    round from agree to rel ``TOL``, and may lie on the two sides of a
    rounding boundary. The -1e4 fill of absent frames must be equal."""
    got, want = np.asarray(got, np.float16), np.asarray(want, np.float16)
    fill = want == np.float16(-1e4)
    np.testing.assert_array_equal(got == np.float16(-1e4), fill)
    ulp = np.maximum(np.spacing(np.abs(got)), np.spacing(np.abs(want))).astype(np.float32)
    scale = np.abs(want[~fill].astype(np.float32)).max()
    assert (np.abs(got.astype(np.float32) - want.astype(np.float32)) <= ulp + TOL * scale).all()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_slot_cross_attention_layer_matches_jax():
    cfg, jm, params, pm = models()
    rng = np.random.RandomState(7)
    M, L = QC + NS, FQ
    tgt, qpos, sq = (rng.randn(1, M, C).astype(np.float32) for _ in range(3))
    memory = rng.randn(1, L, C).astype(np.float32)
    row_valid = np.array([[1, 0, 1, 1, 0, 1, 1, 1]], bool)  # two dead table rows
    want = jm.apply(params, tgt, memory, None, qpos, sq, None, row_valid,
                    method=_jax_cutter(jm, lambda c, *a: c.slot_cross_layers[1](*a)))
    with torch.no_grad():
        got = pm.tracker.slot_cross_attention_layers[1](
            _t(tgt), _t(memory), None, _t(qpos), _t(sq), None, _t(row_valid))
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) <= 1e-5
    # the dead rows do change the live ones when they are not masked (by ten
    # times the tolerance and more)
    with torch.no_grad():
        unmasked = pm.tracker.slot_cross_attention_layers[1](_t(tgt), _t(memory), None, _t(qpos), _t(sq))
    assert rel_err(unmasked.numpy()[0, row_valid[0]], np.asarray(want)[0, row_valid[0]]) > 1e-4


def test_sgff_update_matches_jax():
    from dvis_plus_tpu.models.daq.cutter import sgff_update as jax_sgff
    from dvis_plus_tpu_torch.models.daq.cutter import sgff_update

    rng = np.random.RandomState(8)
    count = np.array([0, 1, 2, 5, 9, 10, 11, 23], np.int32)  # first, partial, full, wrapped rings
    S = count.shape[0]
    sg, new = rng.randn(S, C).astype(np.float32), rng.randn(S, C).astype(np.float32)
    cache = rng.randn(S, 10, C).astype(np.float32)
    cache[:, :, :4] += 2.0  # positive similarities as well as negative ones
    new[:, :4] += 2.0
    want = jax.vmap(jax_sgff)(sg, cache, count, new)
    got = sgff_update(_t(sg), _t(cache), _t(count).long(), _t(new))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def _slot_cost(rng, alive: int, rows: int = 55, cols: int = 100):
    slots = rng.randn(rows, C).astype(np.float32)
    queries = rng.randn(cols, C).astype(np.float32)
    row_valid = np.zeros(rows, bool)
    row_valid[:alive] = True
    row_valid[rows - 5 :] = True  # the background slots are always live
    return slots, queries, row_valid


@pytest.mark.parametrize("alive", [50, 20, 0])
def test_auction_on_daq_slot_costs_is_independent_of_the_check_schedule(alive):
    """55 x 100 slot costs, dead rows all 2.0: the port's auction equals the
    JAX one whether it checks convergence after every round or first after
    16 and then at doubling intervals (a converged auction is a fixed
    point)."""
    from dvis_plus_tpu.ops.assignment import auction_lap as jax_auction
    from dvis_plus_tpu_torch.ops.assignment import auction_lap

    slots, queries, row_valid = _slot_cost(np.random.RandomState(alive), alive)
    a = slots / (np.linalg.norm(slots, axis=1, keepdims=True) + 1e-6)
    b = queries / (np.linalg.norm(queries, axis=1, keepdims=True) + 1e-6)
    cost = np.where(row_valid[:, None], 1.0 - a @ b.T, 2.0).astype(np.float32)
    want = np.asarray(jax_auction(jnp.asarray(cost)))
    for first_check in (1, 16, 5000):
        got = auction_lap(torch.from_numpy(cost), first_check=first_check).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"first_check={first_check}")
    assert len(set(want.tolist())) == 55


@pytest.mark.parametrize("rows", [QC + NS, FQ + 3])
def test_match_slots_to_seg_matches_jax(rows):
    """Both branches: no more slots than queries (the auction alone) and
    more (each query to one slot, the rest to their row's cheapest)."""
    cfg, jm, params, pm = models()
    slots, queries, row_valid = _slot_cost(np.random.RandomState(rows), 3, rows, FQ)
    want = jm.apply(params, slots, queries, row_valid,
                    method=_jax_cutter(jm, lambda c, *a: c._match_slots_to_seg(*a)))
    got = pm.tracker._match_slots_to_seg(_t(slots), _t(queries), _t(row_valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the cutter frame by frame
# ---------------------------------------------------------------------------


class Recorder:
    """Wraps the port cutter's heads to record every value the step
    compares with a threshold."""

    def __init__(self, cutter):
        self.scores, self.slot_scores, self.mask_logits = [], [], []
        self.cutter = cutter
        pred, cls, pos = cutter._prediction, cutter._class_logits, cutter._mask_pos

        def prediction(x, mf):
            logits, masks = pred(x, mf)
            self.scores.append(logits.softmax(-1)[:, :-1].max(-1).values.detach().numpy())
            return logits, masks

        def class_logits(x):
            out = cls(x)
            self.slot_scores.append(out.softmax(-1)[:, :-1].max(-1).values.detach().numpy())
            return out

        def mask_pos(masks, mf):
            self.mask_logits.append(masks.detach().numpy())
            return pos(masks, mf)

        cutter._prediction, cutter._class_logits, cutter._mask_pos = prediction, class_logits, mask_pos

    def close(self):
        for name in ("_prediction", "_class_logits", "_mask_pos"):
            delattr(self.cutter, name)


@pytest.fixture(scope="module")
def steps():
    return run_steps()


@functools.cache
def run_steps():
    """JAX and port cutter steps over the 7 frames of one video, the first
    frame's validity from the segmenter's scores, with what the port
    compared against each threshold."""
    from dvis_plus_tpu.models.daq.cutter import init_cutter_state as jax_init
    from dvis_plus_tpu.models.meta.daq import DAQOnline as JaxOnline
    from dvis_plus_tpu_torch.models.daq.cutter import init_cutter_state

    cfg, jm, params, pm = models()
    d = cfg.model.daq
    images = video()
    seg = jax.jit(functools.partial(jm.apply, method=JaxOnline.segment_only))(params, jnp.asarray(images))
    with torch.no_grad():
        pseg = pm.segment_only(torch.from_numpy(images).permute(0, 3, 1, 2))
    seg_scores = np.asarray(jax.nn.softmax(seg["pred_logits"][0], -1)[:, :-1].max(-1))
    valid = seg_scores > d.aux_inference_select_thr
    js, ps = jax_init(QC, C), init_cutter_state(QC, C)
    rec = Recorder(pm.tracker)
    frames = []
    jax_step = jax.jit(functools.partial(jm.apply, method=JaxOnline.cutter_step), static_argnums=7)
    try:
        for t in range(T):
            jo, js = jax_step(params, js, seg["pred_embds_without_norm"][t], seg["mask_features"][t],
                              seg["query_feat"], seg["pred_masks"][t], valid, t == 0)
            with torch.no_grad():
                po, ps = pm.cutter_step(ps, pseg["pred_embds_without_norm"][t], pseg["mask_features"][t],
                                        pseg["query_feat"], pseg["pred_masks"][t], _t(valid), first=t == 0)
            frames.append((jax.device_get((jo, js)), (po, ps)))
    finally:
        rec.close()
    return cfg, seg_scores, rec, frames, pseg


def test_thresholded_values_keep_their_margin(steps):
    """Every score the step compares with a threshold, and every mask logit
    it thresholds (sigmoid > 0.5), is more than 1e-4 away from it; so the
    parity test below fails only on a fault."""
    cfg, seg_scores, rec, frames, _ = steps
    d = cfg.model.daq
    assert np.abs(seg_scores - d.aux_inference_select_thr).min() > MARGIN
    # live track rows and the new-instance rows of every steady frame
    for t, scores in enumerate(rec.scores[1:], start=1):
        live = np.concatenate([np.asarray(frames[t - 1][0][1].alive), np.ones(FQ, bool)])
        assert np.abs(scores[live] - d.inference_select_thr).min() > MARGIN, t
        slot_live = np.asarray(frames[t - 1][0][1].alive)
        if slot_live.any():
            assert np.abs(rec.slot_scores[t - 1][:QC][slot_live] - d.keep_threshold).min() > MARGIN, t
    assert min(np.abs(m).min() for m in rec.mask_logits) > MARGIN
    assert len(rec.slot_scores) == T - 1 and len(rec.mask_logits) == 2 * T - 1


def test_inference_step_state_and_outputs_match_jax(steps):
    _, _, _, frames, _ = steps
    for t, ((jo, js), (po, ps)) in enumerate(frames):
        for key in ("alive", "seq_id"):
            np.testing.assert_array_equal(po[key].numpy(), np.asarray(jo[key]), err_msg=f"{key} t={t}")
        np.testing.assert_array_equal(ps.invalid_frames.numpy(), np.asarray(js.invalid_frames))
        np.testing.assert_array_equal(ps.pos_count.numpy(), np.asarray(js.pos_count))
        assert int(ps.next_seq) == int(js.next_seq)
        alive = po["alive"].numpy()
        for key in ("slot_logits", "slot_masks", "slot_embeds", "slot_sg_pos"):
            assert rel_err(po[key].numpy()[alive], np.asarray(jo[key])[alive]) <= TOL, (key, t)
        assert rel_err(ps.pos_cache.numpy(), np.asarray(js.pos_cache)) <= TOL


def test_cutter_window_equals_the_frame_steps(steps):
    """The port's window loop (one stacked output a window) gives the frame
    steps' outputs exactly."""
    from dvis_plus_tpu_torch.models.daq.cutter import init_cutter_state

    _, _, _, frames, seg = steps
    _, _, _, pm = models()
    state = frames[0][1][1]
    with torch.no_grad():
        outs, state = pm.cutter_window(state, seg["pred_embds_without_norm"][1:], seg["mask_features"][1:],
                                       seg["query_feat"], seg["pred_masks"][1:])
    for t in range(1, T):
        for key, value in frames[t][1][0].items():
            assert torch.equal(outs[key][t - 1], value), (key, t)
    assert torch.equal(state.seq_id, frames[-1][1][1].seq_id)
    assert init_cutter_state(QC, C).alive.sum() == 0


# ---------------------------------------------------------------------------
# the stream over windows, the sequences, the offline refiner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def streams():
    """JAX and port ``stream_video`` + ``collect_sequences`` (two windows
    of 4 frames, the second ragged), with the port's per-frame states."""
    from dvis_plus_tpu.engine import daq_inference as J
    from dvis_plus_tpu_torch.engine import daq_inference as P

    cfg, jm, params, pm = models()
    images = video()
    window_fns = {}
    jrec, T_, shape4 = J.stream_video(cfg, jm, params, images, window_fns)
    want = J.collect_sequences(cfg, jrec, T_, shape4)
    states = []
    step = pm.tracker.inference_step

    def recording_step(*args, **kwargs):
        out, state = step(*args, **kwargs)
        states.append(state)
        return out, state

    pm.tracker.inference_step = recording_step
    try:
        with torch.no_grad():
            prec, T2, shape4_2, features = P.stream_video(cfg, pm, images, keep_features=True)
    finally:
        del pm.tracker.inference_step
    got = P.collect_sequences(cfg, prec, T2, shape4_2)
    return cfg, (jrec, want), (prec, got), states, features


def test_stream_records_match_jax(streams):
    _, (jrec, _), (prec, _), _, _ = streams
    assert sorted(prec) == sorted(jrec)
    for sid, r in jrec.items():
        p = prec[sid]
        assert (p.start, p.frames) == (r.start, r.frames), sid
        assert rel_err(np.stack(p.logits), np.stack(r.logits)) <= TOL
        assert rel_err(np.stack(p.embeds), np.stack(r.embeds)) <= TOL
        assert_fp16_close(np.stack(p.masks), np.stack(r.masks))


def test_collected_sequences_match_jax(streams):
    _, (_, want), (_, got), _, _ = streams
    assert got[4] == want[4] and len(got[4]) > 0
    assert rel_err(got[0], want[0]) <= TOL
    assert_fp16_close(got[1], want[1])
    assert rel_err(got[2], want[2]) <= TOL
    np.testing.assert_array_equal(got[3], want[3])


def test_stream_covers_the_bookkeeping(streams):
    """The run starts a sequence after frame 0, keeps a track through a
    missed frame, kicks a track out (it ends before the video does), and
    drops a sequence shorter than ``noise_frame_num`` as noise."""
    cfg, _, (prec, got), states, _ = streams
    assert len(states) == T
    assert any(r.start > 0 for r in prec.values())
    assert any(bool((s.alive & (s.invalid_frames > 0)).any()) for s in states)
    assert any(r.frames[-1] + 1 < T for r in prec.values())
    noise = [sid for sid, r in prec.items() if len(r.frames) < cfg.model.daq.noise_frame_num
             and r.frames[-1] + 1 < T]
    assert noise and not set(noise) & set(got[4])


@pytest.fixture(scope="module")
def offline():
    """DAQ offline: the JAX and port streams, the sequences (fewer than
    ``offline_topk_num``), and both ``_offline_refine``."""
    from dvis_plus_tpu.engine import daq_inference as J
    from dvis_plus_tpu_torch.engine import daq_inference as P

    cfg, jm, params, pm = models("daq_offline")
    images = video(2)
    window_fns = {}
    jrec, T_, shape4 = J.stream_video(cfg, jm, params, images, window_fns)
    pred_cls, full_masks, embeds, tv, _ = J.collect_sequences(cfg, jrec, T_, shape4)
    want = J._offline_refine(cfg, jm, params, window_fns, pred_cls, full_masks, embeds, tv, jrec, images)
    with torch.no_grad():
        _, _, _, features = P.stream_video(cfg, pm, images, keep_features=True)
        got = P._offline_refine(cfg, pm, pred_cls, embeds, features)
    return cfg, jm, params, pm, (pred_cls, embeds, features), got, want


def test_offline_refine_matches_jax(offline):
    cfg, _, _, _, (pred_cls, _, _), got, want = offline
    assert 0 < pred_cls.shape[0] < cfg.model.daq.offline_topk_num
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    assert rel_err(got[0], want[0]) <= TOL
    assert_fp16_close(got[1], want[1])


def test_refiner_instance_mask_matches_jax(offline):
    """The refiner's embed pass on 20 rows, the padded ones masked: equal
    to the JAX pass in fp32 (rel <= 1e-4), and different from an unmasked
    pass on the real rows (the masking is exercised)."""
    from dvis_plus_tpu.models.meta.daq import DAQOffline as JaxOffline

    cfg, jm, params, pm, (_, embeds, (frame, _)), _, _ = offline
    N, Qr = embeds.shape[0], cfg.model.daq.offline_topk_num
    inst = np.concatenate([embeds, np.zeros((Qr - N,) + embeds.shape[1:], np.float32)])
    inst = np.ascontiguousarray(inst.swapaxes(0, 1)[None])  # (1, T, Qr, C)
    mask = (np.arange(Qr) < N)[None]
    frame_np = frame.numpy()[None]
    want = jax.jit(functools.partial(jm.apply, method=JaxOffline.refine_embeds))(
        params, jnp.asarray(inst), jnp.asarray(frame_np), jnp.asarray(mask))
    with torch.no_grad():
        got = pm.refine_embeds(_t(inst), _t(frame_np), _t(mask))
        unmasked = pm.refine_embeds(_t(inst), _t(frame_np), torch.ones(1, Qr, dtype=torch.bool))
    for key in ("pred_logits", "mask_embed"):
        assert rel_err(got[key][:, :N].numpy() if key == "pred_logits" else got[key][:, :, :N].numpy(),
                       np.asarray(want[key])[:, :N] if key == "pred_logits"
                       else np.asarray(want[key])[:, :, :N]) <= TOL, key
    assert rel_err(unmasked["pred_logits"][:, :N].numpy(), np.asarray(want["pred_logits"])[:, :N]) > 1e-3


# ---------------------------------------------------------------------------
# VOS output
# ---------------------------------------------------------------------------


def _smooth(rng, n, T_, h, w, scale=4.0):
    coarse = rng.randn(n, T_, h // 4, w // 4).astype(np.float32) * scale
    return coarse.repeat(4, axis=2).repeat(4, axis=3) + 0.3 * rng.randn(n, T_, h, w).astype(np.float32)


def test_vos_output_pngs_match_jax(tmp_path):
    """Both ``_vos_output`` on the same sequences and first-frame objects
    (canvas 64x96, valid 48x72, output 60x90, stride-4 masks 16x24): every
    label PNG equal to the JAX function's, pixel for pixel."""
    import cv2

    from dvis_plus_tpu.engine.daq_inference import _vos_output as jax_vos
    from dvis_plus_tpu_torch.engine.daq_inference import _vos_output

    cfg = daq_cfg()
    rng = np.random.RandomState(9)
    N, T_ = 6, 3
    full_masks = _smooth(rng, N, T_, 16, 24).astype(np.float16)
    pred_cls = rng.randn(N, K + 1).astype(np.float32) * 3
    gt = np.zeros((3, 64, 96), bool)
    for g in range(3):  # the given objects: each near one predicted track's first-frame mask
        up = np.kron(full_masks[2 * g, 0].astype(np.float32) > 0, np.ones((4, 4))) > 0
        gt[g] = up
    sample = {"images": np.zeros((T_, 64, 96, 3), np.float32), "image_size": [48, 72], "height": 60,
              "width": 90, "video_name": "vid", "file_names": [f"vid/{t:05d}.jpg" for t in range(T_)],
              "first_frame_masks": gt, "first_frame_ids": [1, 3, 4]}
    outs = {}
    for name, fn in (("jax", jax_vos), ("port", _vos_output)):
        cfg.output_dir = str(tmp_path / name)
        fn(cfg, sample, pred_cls, full_masks)
        outs[name] = [cv2.imread(str(tmp_path / name / "inference" / "vid" / f"{t:05d}.png"),
                                 cv2.IMREAD_UNCHANGED) for t in range(T_)]
    for t, (got, want) in enumerate(zip(outs["port"], outs["jax"])):
        assert got.shape == want.shape == (60, 90), t
        np.testing.assert_array_equal(got, want, err_msg=f"frame {t}")
    labels = set(np.unique(np.stack(outs["port"])).tolist())
    assert {0, 1, 3, 4} <= labels


def test_vos_output_skips_a_sample_without_first_frame_masks(tmp_path, caplog):
    from dvis_plus_tpu_torch.engine.daq_inference import _vos_output

    cfg = daq_cfg()
    cfg.output_dir = str(tmp_path)
    _vos_output(cfg, {"images": np.zeros((2, 64, 96, 3))}, np.zeros((3, K + 1), np.float32),
                np.zeros((3, 2, 16, 24), np.float16))
    assert "first-frame" in caplog.text and not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# the class-agnostic VOS mapper
# ---------------------------------------------------------------------------


def test_sot_eval_mapper_equals_jax():
    """``mapper_for_type(cfg, "video_sot")`` against the JAX package's
    ``SOTDatasetMapper(cfg, is_train=False)`` on a record with annotations
    of several categories (the mapper relabels them to 0; the eval output
    reads none): every output equal, the port's uint8 canvas once normalized
    as the eval loops normalize it (``_frames``)."""
    from dvis_plus_tpu.core.config import load_config as jax_load_config
    from dvis_plus_tpu.data.mapper_sot import SOTDatasetMapper as JaxSOT
    from dvis_plus_tpu_torch.config import load_config
    from dvis_plus_tpu_torch.data.mapper import SOTDatasetMapper, mapper_for_type

    yaml, opts = "configs/daq/daq_vos_r50_ytvos.yaml", ["input.min_size_test=48", "input.max_size_test=80"]
    rng = np.random.RandomState(4)
    frames = [rng.randint(0, 256, (64, 96, 3)).astype(np.uint8) for _ in range(3)]
    record = {"_frames": frames, "length": 3, "height": 64, "width": 96, "video_id": 5,
              "file_names": [f"v/{t:05d}.jpg" for t in range(3)],
              "annotations": [[{"category_id": c, "id": 1}] for c in (1, 2, 3)]}
    cfg = load_config(yaml, opts)
    got_map = mapper_for_type(cfg, "video_sot")
    assert isinstance(got_map, SOTDatasetMapper)
    got = on_card_canvas(cfg, got_map(dict(record), seed=0))
    want = JaxSOT(jax_load_config(yaml, opts), is_train=False)(dict(record), seed=0)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["images"].shape == (3, 64, 96, 3) and "first_frame_masks" not in got
    assert [a[0]["category_id"] for a in record["annotations"]] == [1, 2, 3]  # not mutated


def test_uni_ytvis_evaluator_writes_what_jax_writes(tmp_path):
    """MOTS evaluator: the YTVIS rows and the per-key BDD dict outputs, the
    same files as the JAX ``UniYTVISEvaluator.evaluate`` writes."""
    from dvis_plus_tpu.evaluation.evaluators import UniYTVISEvaluator as JaxUni
    from dvis_plus_tpu_torch.evaluation.evaluators import UniYTVISEvaluator

    masks = [np.zeros((2, 8, 12), bool), np.ones((2, 8, 12), bool)]
    masks[0][1, 2:5, 3:9] = True
    output = {"pred_scores": [0.9, 0.4], "pred_labels": [2, 0], "pred_masks": masks}
    bdd = {"seg_track": [{"video": 3, "id": 1}], "det": [{"box": [1, 2, 3, 4]}]}
    outs = {}
    for name, kind in (("jax", JaxUni), ("port", UniYTVISEvaluator)):
        ev = kind("bdd_seg_track_val", str(tmp_path / name), contiguous_to_dataset_id={2: 3})
        ev.process(7, output)
        ev.process_bdd(bdd)
        ev.process_bdd({"det": [{"box": [5, 6, 7, 8]}]})
        ev.evaluate() if name == "jax" else ev.write_results()
        outs[name] = {f: open(tmp_path / name / f).read() for f in sorted(os.listdir(tmp_path / name))}
    assert outs["port"] == outs["jax"]
    assert sorted(outs["port"]) == ["det.json", "results.json", "seg_track.json"]
