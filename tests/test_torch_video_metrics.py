"""The port's video metrics, evaluators and offline scorers against the JAX
package's (``dvis_plus_tpu/evaluation/{video_metrics,offline_scoring,evaluators}.py``):

- VPQ (with crowd tubes), STQ, mIoU and VC on seeded label maps: equal dicts
  and numbers, exactly;
- the VPS and VSS evaluators on the synthetic VIPSeg and VSPW trees: the port's
  ``pred.json`` equals the JAX evaluator's, every PNG decodes (cv2) to the
  same pixels, and ``evaluate()`` (``score_vps`` / ``score_vss`` on the
  ground truth) gives the same dict, exactly.
"""
import json
import os
import sys

import cv2
import numpy as np
import pytest

from dvis_plus_tpu.evaluation import evaluators as jax_evaluators
from dvis_plus_tpu.evaluation import video_metrics as jax_metrics
from dvis_plus_tpu_torch.evaluation import evaluators, video_metrics

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from synth_data import make_vipseg, make_vspw  # noqa: E402

NUM_CLASSES = 6


def _video(rng, T=5, H=12, W=14):
    """(cls, id) maps: blocks of a few classes and ids, some void (255)."""
    cls = rng.randint(0, NUM_CLASSES, (T, H // 4, W // 2)).repeat(4, 1).repeat(2, 2)
    ids = rng.randint(0, 3, cls.shape)
    cls[rng.rand(*cls.shape) < 0.05] = 255
    return cls.astype(np.int64), ids.astype(np.int64)


def _pred_of(rng, gt):
    cls, ids = (x.copy() for x in gt)
    flip = rng.rand(*cls.shape) < 0.15
    cls[flip] = rng.randint(0, NUM_CLASSES, flip.sum())
    ids[rng.rand(*ids.shape) < 0.1] += 1
    return cls, ids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax(seed):
    rng = np.random.RandomState(seed)
    gts = [_video(rng) for _ in range(3)]
    preds = [_pred_of(rng, g) for g in gts]
    crowds = [{(int(g[0][0, 0, 0]), int(g[1][0, 0, 0]))} if g[0][0, 0, 0] != 255 else set() for g in gts]
    for fn in (lambda m: m.vpq_eval(preds, gts, NUM_CLASSES, windows=(1, 2, 4), gt_crowds=crowds),
               lambda m: m.stq_eval(preds, gts, NUM_CLASSES, num_things=0, things=[0, 1, 2]),
               lambda m: m.miou_eval([p[0] for p in preds], [g[0] for g in gts], NUM_CLASSES),
               lambda m: [m.vc_eval([p[0] for p in preds], [g[0] for g in gts], n=n) for n in (2, 3)]):
        assert fn(video_metrics) == fn(jax_metrics)
    assert 0.0 < video_metrics.vpq_eval(preds, gts, NUM_CLASSES)["VPQ"] < 100.0


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("metric_trees"))
    make_vipseg(root, n_videos=2, length=4)
    make_vspw(root, n_videos=2, length=4)
    return root


def _vps_predictions(root):
    """Per video: the GT id map with a moved thing and a void patch, as a
    model's panoptic_seg with contiguous categories (things first: dataset
    ids 0, 1 are things, 2 is stuff)."""
    base = os.path.join(root, "VIPSeg", "VIPSeg_720P")
    with open(os.path.join(base, "panoptic_gt_VIPSeg_val.json")) as f:
        gt = json.load(f)
    for v, video in enumerate(gt["annotations"]):
        segs = []
        for fr in video["annotations"]:
            lab = cv2.imread(os.path.join(base, "panomasksRGB", video["video_id"], fr["file_name"]))
            lab = lab[:, :, ::-1].astype(np.int64)
            ids = lab[..., 0] + 256 * lab[..., 1] + 65536 * lab[..., 2]
            seg = np.where(ids == 21, 1, 2).astype(np.int32)  # thing -> 1, stuff -> 2
            seg = np.roll(seg, v + 1, axis=1)
            seg[:5, :7] = 0
            segs.append(seg)
        names = [os.path.join("x", fr["file_name"].replace(".png", ".jpg")) for fr in video["annotations"]]
        infos = [{"id": 1, "isthing": True, "category_id": 0}, {"id": 2, "isthing": False, "category_id": 2},
                 {"id": 3, "isthing": True, "category_id": 1}]  # id 3 is in no frame: no row
        yield video["video_id"], names, np.stack(segs), infos


def test_vps_evaluator_and_scores_equal_jax(trees, tmp_path):
    base = os.path.join(trees, "VIPSeg", "VIPSeg_720P")
    kw = dict(contiguous_to_dataset_id={0: 0, 1: 1, 2: 2}, gt_json=os.path.join(base, "panoptic_gt_VIPSeg_val.json"),
              gt_dir=os.path.join(base, "panomasksRGB"))
    got_ev = evaluators.VPSEvaluator("v", str(tmp_path / "port"), **kw)
    want_ev = jax_evaluators.VPSEvaluator("v", str(tmp_path / "jax"), **kw)
    for args in _vps_predictions(trees):
        got_ev.process(*args)
        want_ev.process(*args)
    got, want = got_ev.evaluate(), want_ev.evaluate()
    assert got == want and want["videos"] == 2 and 0.0 < want["VPQ"] < 100.0 and "STQ" in want
    with open(tmp_path / "port" / "pred.json") as f, open(tmp_path / "jax" / "pred.json") as g:
        assert json.load(f) == json.load(g)
    for vid in ("video_0001", "video_0002"):
        for t in range(4):
            rel = os.path.join("pan_pred", vid, f"{t:05d}.png")
            a = cv2.imread(str(tmp_path / "port" / rel), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(tmp_path / "jax" / rel), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(a, b)


def test_vss_evaluator_and_scores_equal_jax(trees, tmp_path):
    gt_root = os.path.join(trees, "VSPW_480p")
    got_ev = evaluators.VSSEvaluator("s", str(tmp_path / "port"), gt_root=gt_root)
    want_ev = jax_evaluators.VSSEvaluator("s", str(tmp_path / "jax"), gt_root=gt_root)
    rng = np.random.RandomState(3)
    for vid in ("video_0001", "video_0002"):
        masks = np.stack([cv2.imread(os.path.join(gt_root, "data", vid, "mask", f"{t:05d}.png"), 0)
                          for t in range(4)]).astype(np.int64) - 1  # the 0-based classes
        masks[rng.rand(*masks.shape) < 0.1] = 7
        names = [f"{t:05d}.jpg" for t in range(4)]
        got_ev.process(vid, names, masks.astype(np.uint8))
        want_ev.process(vid, names, masks)  # the JAX loop hands over int64 class maps
    got, want = got_ev.evaluate(), want_ev.evaluate()
    assert got == want and want["videos"] == 2 and 0.0 < want["mIoU"] < 100.0 and "VC8" in want
    for vid in ("video_0001", "video_0002"):
        for t in range(4):
            rel = os.path.join(vid, f"{t:05d}.png")
            np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / rel), cv2.IMREAD_UNCHANGED),
                                          cv2.imread(str(tmp_path / "jax" / rel), cv2.IMREAD_UNCHANGED))


def test_evaluators_without_ground_truth_count_videos(tmp_path):
    ev = evaluators.VPSEvaluator("v", str(tmp_path / "vps"))
    ev.process("a", ["f0.jpg"], np.zeros((1, 4, 5), np.int32), [])
    assert ev.evaluate() == {"videos": 1}
    assert json.load(open(tmp_path / "vps" / "pred.json")) == {
        "annotations": [{"video_id": "a", "annotations": [{"file_name": "f0.png", "segments_info": []}]}]}
    ev = evaluators.VSSEvaluator("s", str(tmp_path / "vss"))
    ev.process("a", ["f0.jpg"], np.zeros((1, 4, 5), np.uint8))
    assert ev.evaluate() == {"videos": 1} and os.path.exists(tmp_path / "vss" / "a" / "f0.png")
