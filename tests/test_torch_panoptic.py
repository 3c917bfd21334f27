"""The VPS and VSS heads of the port against the JAX package's
(``dvis_plus_tpu/models/meta/dvis_online.py``: ``semantic_inference``,
``panoptic_probs``, ``panoptic_segments_host``), on seeded inputs, fp32.

- ``panoptic_probs`` and ``semantic_inference``, with and without aux
  logits, with a second resize that upsamples and one that downsamples (the
  antialiasing filter): mask probabilities rel <= 1e-5; scores rel <= 1e-6;
  labels, keep, per-pixel query ids and class maps equal.
- The device bookkeeping (``panoptic_segments_device`` over time chunks) and
  the port's ``panoptic_segments_host`` equal the JAX
  ``panoptic_segments_host`` on the fp16 masks the JAX eval loop stores: the
  same id map and the same ``segments_infos``, on inputs built to hit
  probabilities within an fp16 ulp below 0.5, stuff classes that merge, a
  segment that the overlap test drops and pixels where no query is kept.
- The VPS and VSS loops of the two packages on the tiny DVIS++ online model,
  with the masks kept on the device and paged to host fp16: the same id
  maps, segments and class maps.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvis_plus_tpu.engine.inference as jax_inference
from dvis_plus_tpu.models.meta import dvis_online as jax_heads
from dvis_plus_tpu_torch.engine import inference
from dvis_plus_tpu_torch.models.meta import dvis_online as heads
from tests.test_torch_common import _scaled, images, jax_model_and_params, port_model, rel_err

torch.set_num_threads(2)

Q, K, T = 8, 5, 3
# (img_size, output_size, padded_size): the second resize upsamples, then
# downsamples (VSPW's 480p output of a 720p model input)
GEOMETRY = {"up": ((28, 40), (45, 61), (32, 40)), "down": ((56, 80), (37, 51), (64, 96))}


def _inputs(seed, padded):
    rng = np.random.RandomState(seed)
    logits = (3.0 * rng.randn(Q, K + 1)).astype(np.float32)
    aux = (3.0 * rng.randn(Q, K + 1)).astype(np.float32)
    masks = (4.0 * rng.randn(Q, T, padded[0] // 4, padded[1] // 4)).astype(np.float32)
    return logits, aux, masks


@pytest.mark.parametrize("geometry", sorted(GEOMETRY))
@pytest.mark.parametrize("with_aux", [False, True])
def test_panoptic_probs_matches_jax(geometry, with_aux):
    img, out, pad = GEOMETRY[geometry]
    logits, aux, masks = _inputs(0, pad)
    aux = aux if with_aux else None
    want = jax_heads.panoptic_probs(jnp.asarray(logits), jnp.asarray(masks), img, out, pad, 0.3,
                                    None if aux is None else jnp.asarray(aux))
    got = heads.panoptic_probs(torch.from_numpy(logits), torch.from_numpy(masks), img, out, pad, 0.3,
                               None if aux is None else torch.from_numpy(aux))
    w_scores, w_labels, w_keep, w_masks, w_ids = (np.asarray(x) for x in want)
    g_scores, g_labels, g_keep, g_masks, g_ids = (x.numpy() for x in got)
    assert rel_err(g_scores, w_scores) <= 1e-6
    np.testing.assert_array_equal(g_labels, w_labels)
    np.testing.assert_array_equal(g_keep, w_keep)
    assert 0 < w_keep.sum() < Q  # some queries kept, some dropped
    assert g_masks.shape == (Q, T, *out) and rel_err(g_masks, w_masks) <= 1e-5
    np.testing.assert_array_equal(g_ids, w_ids)


@pytest.mark.parametrize("geometry", sorted(GEOMETRY))
@pytest.mark.parametrize("with_aux", [False, True])
def test_semantic_inference_matches_jax(geometry, with_aux):
    img, out, pad = GEOMETRY[geometry]
    logits, aux, masks = _inputs(1, pad)
    aux = aux if with_aux else None
    want = np.asarray(jax_heads.semantic_inference(
        jnp.asarray(logits), jnp.asarray(masks), img, out, pad, None if aux is None else jnp.asarray(aux)))
    got = heads.semantic_inference(torch.from_numpy(logits), torch.from_numpy(masks), img, out, pad,
                                   None if aux is None else torch.from_numpy(aux)).numpy()
    assert got.shape == (T, *out) and len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)


def _bookkeeping(scores, labels, keep, masks, mask_ids, n_things, thr, chunk=2):
    """(JAX host, port host, port device over time chunks of ``chunk``) on
    the same inputs; the host versions take the fp16 masks."""
    m16 = masks.astype(np.float16)
    want = jax_heads.panoptic_segments_host(scores, labels, keep, m16, mask_ids, n_things, thr)
    host = heads.panoptic_segments_host(scores, labels, keep, m16, mask_ids, n_things, thr)
    mt, it = torch.from_numpy(masks), torch.from_numpy(mask_ids.astype(np.int64))
    chunks = [(mt[:, s : s + chunk], it[s : s + chunk]) for s in range(0, mask_ids.shape[0], chunk)]
    seg, infos, ids = heads.panoptic_segments_device(
        torch.from_numpy(scores), torch.from_numpy(labels), torch.from_numpy(keep), chunks, n_things, thr)
    return want, host, (seg.numpy(), infos, ids)


def _assert_same(want, *others):
    for got in others:
        assert got[0].dtype == np.int32
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and list(got[2]) == list(want[2])


def _crafted():
    """Six queries, 2 thing classes (0, 1), stuff classes 2 and 3, on a
    (2, 4, 10) video. Returns (scores, labels, keep, masks, mask_ids) with
    mask_ids computed as the device does (argmax of the kept
    ``score * mask``)."""
    T_, H, W = 2, 4, 10
    below = np.float32(0.5 - 2.0 ** -13)  # rounds to 0.5 in fp16: inside
    just_below = np.nextafter(below, np.float32(0))  # rounds below 0.5: outside
    masks = np.zeros((6, T_, H, W), np.float32)
    # query 0: not kept (its label is the no-object class); pixels no kept
    # query covers go to it
    masks[0] = 0.9
    # query 1: thing, left columns; its edge column sits at the fp16 boundary
    masks[1, :, :, 0:2] = 0.95
    masks[1, :, :, 2] = below
    masks[1, 0, :, 3] = just_below
    # queries 2 and 3: the same stuff class 2 in two places: merged
    masks[2, :, :, 4] = 0.9
    masks[3, :, :, 5] = 0.9
    # query 4: stuff class 3, columns 5-9, of which queries 3 and 5 take
    # 5-7: dropped by the overlap test at 0.8, kept at 0.3
    masks[4, :, :, 5:10] = 0.7
    # query 5: thing, its mask covers columns 6-7
    masks[5, :, :, 6:8] = 0.99
    masks[:, :, 3, 9] = 0.0  # a pixel where every kept query is 0
    scores = np.array([0.9, 0.8, 0.7, 0.75, 0.6, 0.95], np.float32)
    labels = np.array([4, 0, 2, 2, 3, 1], np.int64)
    keep = labels != 4
    prob = np.where(keep[:, None, None, None], scores[:, None, None, None] * masks, 0.0)
    return scores, labels, keep, masks, prob.argmax(0)


@pytest.mark.parametrize("thr", [0.8, 0.3])
def test_bookkeeping_on_crafted_cases_matches_jax(thr):
    want, host, dev = _bookkeeping(*_crafted(), n_things=2, thr=thr)
    _assert_same(want, host, dev)
    seg, infos, _ = want
    cats = [i["category_id"] for i in infos]
    if thr == 0.8:  # query 4 (stuff 3) keeps 7 of its 20 pixels a frame: dropped
        assert 3 not in cats and (seg[:, :, 8:] == 0).all()
    else:
        assert 3 in cats
    assert cats.count(2) == 1  # queries 2 and 3 share one stuff segment
    stuff = next(i["id"] for i in infos if i["category_id"] == 2)
    assert (seg[:, :, 4] == stuff).all() and (seg[:, :, 5] == stuff).all()
    assert (seg[:, :, 2] > 0).all() and (seg[0, :, 3] == 0).all()  # the fp16 boundary
    assert (seg[:, 3, 9] == 0).all()  # no kept query: void


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_aux", [False, True])
def test_device_bookkeeping_matches_jax_on_head_outputs(seed, with_aux):
    """Seeded logits through both heads, then the bookkeeping of each
    package: the JAX loop's (fp16 masks to the host) against the port's over
    time chunks, with 3 of the 5 classes things and an overlap threshold of
    0.3 (random masks overlap too much for 0.8 to keep any)."""
    img, out, pad = GEOMETRY["up"]
    logits, aux, masks = _inputs(10 + seed, pad)
    aux = aux if with_aux else None
    scores, labels, keep, m, ids = (np.array(x) for x in jax_heads.panoptic_probs(
        jnp.asarray(logits), jnp.asarray(masks), img, out, pad, 0.0,
        None if aux is None else jnp.asarray(aux)))
    want, host, _ = _bookkeeping(scores, labels, keep, m, ids, 3, 0.3)
    _assert_same(want, host)
    # the port's own device pass: its probabilities and ids, its counts
    lt, mt = torch.from_numpy(logits), torch.from_numpy(masks)
    at = None if aux is None else torch.from_numpy(aux)
    per_chunk = [heads.panoptic_probs(lt, mt[:, s : s + 2], img, out, pad, 0.0, at)[3:] for s in (0, 2)]
    seg, infos, kept = heads.panoptic_segments_device(*heads.panoptic_scores(lt, 0.0, at), per_chunk, 3, 0.3)
    _assert_same(want, (seg.numpy(), infos, kept))
    assert len(infos) > 1


def test_chunk_counts_threshold_after_fp16_rounding():
    below = np.float32(0.5 - 2.0 ** -13)
    m = torch.tensor([below, np.nextafter(below, np.float32(0)), 0.5, 0.4], dtype=torch.float32)
    masks = m.reshape(1, 1, 1, 4).expand(2, 1, 1, 4).contiguous()
    ids = torch.zeros(1, 1, 4, dtype=torch.int64)
    counts, own = heads.panoptic_chunk_counts(masks, ids)
    assert counts.tolist() == [[4, 0], [2, 2], [2, 0]]
    assert own.tolist() == [[[True, False, True, False]]]


class TaskRecorder:
    def __init__(self):
        self.out = {}

    def process(self, video_id, frame_names, maps, segments_infos=None):
        self.out[video_id] = (np.array(maps), segments_infos)


def _task_loader():
    """Videos of 7 and 4 frames (windows of 3: the last ragged); the second
    with padding below its valid region and an upsampling output size."""
    for vid, (T, img, out) in enumerate([(7, (64, 96), (48, 72)), (4, (56, 96), (96, 144))], 1):
        x = images(T, seed=20 + vid)
        x[:, img[0]:] = 0.0
        yield {"images": x, "image_size": np.asarray(img), "height": out[0], "width": out[1],
               "video_id": f"video_{vid}", "file_names": [f"{t:05d}.jpg" for t in range(T)]}


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("task", ["vps", "vss"])
def test_task_loops_match_jax(task, paged, monkeypatch):
    """``run_vps_inference`` / ``run_vss_inference`` of the two packages on
    the tiny DVIS++ online model (seeded weights, fp32, JV): the same id maps
    and segments, the same class maps. ``paged``: a memory budget of ~0 pages
    every window's masks to host fp16 in both packages, and the port brings
    them back one time chunk at a time. Test numbers are video ids."""
    cfg, model, params = jax_model_and_params()
    cfg = copy.deepcopy(cfg)  # the cached configuration stays as it is
    params = _scaled(params, {"class_embed": 4.0, "mask_embed": 6.0})  # contrast: several segments
    cfg.test.overlap_threshold = 0.3
    if paged:
        monkeypatch.setenv("DVIS_OFFLINE_MF_BUDGET_GB", "1e-6")
    want, got = TaskRecorder(), TaskRecorder()
    port = port_model(cfg, params)
    if task == "vps":
        jax_inference.run_vps_inference(cfg, model, params, _task_loader(), want, 3)
        inference.run_vps_inference(cfg, port, _task_loader(), got, 3)
    else:
        jax_inference.run_vss_inference(cfg, model, params, _task_loader(), want)
        inference.run_vss_inference(cfg, port, _task_loader(), got)
    assert sorted(got.out) == sorted(want.out) == ["video_1", "video_2"]
    for vid, (w_maps, w_infos) in want.out.items():
        g_maps, g_infos = got.out[vid]
        assert g_maps.shape == w_maps.shape
        np.testing.assert_array_equal(g_maps, w_maps.astype(g_maps.dtype))
        assert g_infos == w_infos
    if task == "vps":
        assert sum(len(i) for _, i in want.out.values()) > 2
