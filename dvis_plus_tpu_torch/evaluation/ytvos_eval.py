"""Video instance segmentation AP (the YouTube-VOS protocol), on the port's
numpy RLE codec.

Counterpart: ``dvis_plus_tpu/evaluation/ytvos_eval.py`` (``track_iou`` :34,
``_match_one`` :54, ``evaluate_vis`` :103).

- a prediction or a ground truth is a track: per-frame RLE masks (None =
  absent);
- track IoU is spatio-temporal: the sum of per-frame intersection areas over
  the sum of per-frame union areas (plain IoU even for crowd ground truths,
  unlike image COCO);
- COCO-style matching per (video, category): detections sorted by score,
  ground truths sorted ignore-last, greedy best match per detection at each
  IoU threshold (0.50:0.05:0.95); crowd ground truths are ignore-class:
  matchable many times, and a detection matching one becomes ignored;
- AP = mean precision over 101 recall points, averaged over thresholds and
  the categories present in the ground truth; AR = recall at ``max_dets``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from dvis_plus_tpu_torch.utils import rle as rle_codec

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)


def track_iou(
    dt_segs: Sequence[Optional[dict]],
    gt_segs: Sequence[Optional[dict]],
) -> float:
    """Plain spatio-temporal tube IoU from integer per-frame intersection
    and union areas. The video protocol never applies image-COCO crowd IoU."""
    inter = 0
    union = 0
    for d, g in zip(dt_segs, gt_segs):
        if d and g:
            inter += rle_codec.area(rle_codec.merge([d, g], True))
            union += rle_codec.area(rle_codec.merge([d, g], False))
        elif g:
            union += rle_codec.area(g)
        elif d:
            union += rle_codec.area(d)
    return inter / union if union > 0 else 0.0


def _match_one(args):
    """Per-(video, category) IoU matrix and greedy threshold matching: the
    multiprocessing work item.

    GTs sorted ignore-last (stable), per detection the best ``iou >= thr`` GT
    wins with later-equal replacing, matched regular GTs become unavailable,
    ignored (crowd) GTs stay matchable and flag the detection ignored, and
    the scan stops at the ignored tail once a regular match exists.

    Returns (matched, ignored) both (T, n_dt) bool, assuming ``dt`` is
    already score-sorted."""
    dt, gt, crowd = args
    T = len(IOU_THRS)
    # sort gt ignore-last, stable
    order = sorted(range(len(gt)), key=lambda j: int(crowd[j]))
    gt = [gt[j] for j in order]
    gt_ig = [bool(crowd[j]) for j in order]
    ious = np.zeros((len(dt), len(gt)))
    for i, d in enumerate(dt):
        for j, g in enumerate(gt):
            ious[i, j] = track_iou(d["segmentations"], g["segmentations"])
    matched = np.zeros((T, len(dt)), bool)
    ignored = np.zeros((T, len(dt)), bool)
    for ti, thr in enumerate(IOU_THRS):
        gt_used = [False] * len(gt)
        for i in range(len(dt)):
            best = min(thr, 1 - 1e-10)
            m = -1
            for j in range(len(gt)):
                if gt_used[j] and not gt_ig[j]:
                    continue
                if m > -1 and not gt_ig[m] and gt_ig[j]:
                    break  # regular match made; ignored tail can't improve it
                if ious[i, j] < best:
                    continue
                best, m = ious[i, j], j
            if m == -1:
                continue
            gt_used[m] = True
            if gt_ig[m]:
                ignored[ti, i] = True
            else:
                matched[ti, i] = True
    return matched, ignored


def evaluate_vis(
    gt_annotations: List[dict],
    predictions: List[dict],
    num_frames_per_video: Dict[int, int],
    max_dets: int = 100,
    workers: int = 0,
) -> Dict[str, float]:
    """gt_annotations: [{video_id, category_id, segmentations, iscrowd, id}];
    predictions: [{video_id, category_id, segmentations, score}].
    Returns {AP, AP50, AP75, AR100, ...}. ``workers > 1`` parallelizes the
    per-(video, category) tube-IoU matching over processes."""
    gts = defaultdict(list)
    dts = defaultdict(list)
    cat_ids = set()
    for g in gt_annotations:
        gts[(g["video_id"], g["category_id"])].append(g)
        cat_ids.add(g["category_id"])
    for d in predictions:
        dts[(d["video_id"], d["category_id"])].append(d)
    video_ids = sorted(num_frames_per_video)

    T = len(IOU_THRS)
    # build the (cat, vid) work list, then match serially or in a pool
    work = {}
    for cat in sorted(cat_ids):
        for vid in video_ids:
            gt = gts.get((vid, cat), [])
            dt = sorted(dts.get((vid, cat), []), key=lambda d: -d["score"])[:max_dets]
            if not dt:
                continue
            crowd = [bool(g.get("iscrowd", 0)) for g in gt]
            work[(cat, vid)] = (dt, gt, crowd)
    if workers and workers > 1 and len(work) > 8:
        import multiprocessing as mp

        with mp.get_context("fork").Pool(workers) as pool:
            results = dict(zip(work.keys(), pool.map(_match_one, work.values())))
    else:
        results = {k: _match_one(v) for k, v in work.items()}

    # per category: accumulate match flags over all videos
    ap_per_cat = []
    ar_per_cat = []
    ap50_per_cat, ap75_per_cat = [], []
    for cat in sorted(cat_ids):
        dt_scores_all = []
        dt_matched_all = []  # (T, n_dt) bool
        dt_ignored_all = []
        n_gt = 0
        for vid in video_ids:
            gt = gts.get((vid, cat), [])
            crowd = [bool(g.get("iscrowd", 0)) for g in gt]
            n_gt += sum(1 for c in crowd if not c)
            if (cat, vid) not in work:
                continue
            dt = work[(cat, vid)][0]
            matched, ignored = results[(cat, vid)]
            dt_scores_all.extend(d["score"] for d in dt)
            dt_matched_all.append(matched)
            dt_ignored_all.append(ignored)

        if n_gt == 0:
            continue
        if not dt_scores_all:
            ap_per_cat.append(0.0)
            ap50_per_cat.append(0.0)
            ap75_per_cat.append(0.0)
            ar_per_cat.append(0.0)
            continue
        scores = np.asarray(dt_scores_all)
        order = np.argsort(-scores, kind="mergesort")
        matched = np.concatenate(dt_matched_all, axis=1)[:, order]
        ignored = np.concatenate(dt_ignored_all, axis=1)[:, order]

        ap_t = np.zeros(T)
        ar_t = np.zeros(T)
        for ti in range(T):
            keep = ~ignored[ti]
            m = matched[ti][keep]
            tp = np.cumsum(m)
            fp = np.cumsum(~m)
            recall = tp / n_gt
            precision = tp / np.maximum(tp + fp, 1e-9)
            # monotone precision envelope
            for i in range(len(precision) - 1, 0, -1):
                precision[i - 1] = max(precision[i - 1], precision[i])
            # 101-point interpolation
            idx = np.searchsorted(recall, RECALL_THRS, side="left")
            prec_at = np.where(idx < len(precision), precision[np.minimum(idx, max(len(precision) - 1, 0))], 0.0)
            if len(precision) == 0:
                prec_at = np.zeros_like(RECALL_THRS)
            ap_t[ti] = prec_at.mean()
            ar_t[ti] = recall[-1] if len(recall) else 0.0
        ap_per_cat.append(ap_t.mean())
        ap50_per_cat.append(ap_t[0])
        ap75_per_cat.append(ap_t[5])
        ar_per_cat.append(ar_t.mean())

    if not ap_per_cat:
        return {"AP": 0.0, "AP50": 0.0, "AP75": 0.0, "AR100": 0.0}
    return {
        "AP": float(np.mean(ap_per_cat)),
        "AP50": float(np.mean(ap50_per_cat)),
        "AP75": float(np.mean(ap75_per_cat)),
        "AR100": float(np.mean(ar_per_cat)),
    }
