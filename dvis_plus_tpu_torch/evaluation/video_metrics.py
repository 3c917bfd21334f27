"""Offline video segmentation quality metrics: VPQ, STQ, mIoU, VC.

Counterpart: ``dvis_plus_tpu/evaluation/video_metrics.py``, copied: the port
keeps its own copy of the host code it needs, so that it imports nothing of
the JAX package (this module is numpy alone). The metrics follow the
reference's offline scorers (``eval_vpq_vspw.py``, ``eval_stq_vspw.py``,
``eval_miou_vspw.py``, ``eval_vc_vspw.py``):

- VPQ^k: panoptic quality over k-frame tubes: segments are (class, id) tubes
  concatenated over a window; TP when tube IoU > 0.5;
  PQ = sum(IoU_TP) / (|TP| + |FP|/2 + |FN|/2), averaged over classes then
  windows;
- STQ: sqrt(AQ x SQ); AQ = association quality over predicted/GT track pairs
  (IoU-weighted), SQ = semantic mIoU;
- mIoU: per-class intersection/union over all frames;
- VC^n: video consistency: the fraction of the area where all n GT frames
  agree that the prediction also keeps consistent.

Inputs are (T, H, W) integer maps; 255 (or ``ignore``) is void.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _tube_segments(cls_map: np.ndarray, id_map: np.ndarray, ignore: int):
    """(T,H,W) -> {(cls, id): area} plus flattened key map for a window."""
    key = cls_map.astype(np.int64) * (1 << 32) + id_map.astype(np.int64)
    key = np.where(cls_map == ignore, -1, key)
    return key


def vpq_single_window(
    pred_cls, pred_id, gt_cls, gt_id, num_classes: int, ignore: int = 255,
    gt_crowd=frozenset(),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-class (iou_sum, tp, fp, fn) for one tube window. Mirrors the
    reference ``vpq_compute_single_core`` (eval_vpq_vspw.py:77-218) exactly:
    union excludes the prediction's overlap with GT void, crowd GT tubes are
    excluded from matching/FN, and an unmatched prediction is FP-ignored when
    more than half its area lies on void + a same-category crowd segment.

    ``gt_crowd``: set of (class, id) GT tube keys flagged iscrowd."""
    pk = _tube_segments(pred_cls, pred_id, ignore).reshape(-1)
    gk = _tube_segments(gt_cls, gt_id, ignore).reshape(-1)

    pairs, counts = np.unique(np.stack([gk, pk]), axis=1, return_counts=True)
    inter_map = {
        (int(g), int(p)): int(c)
        for (g, p), c in zip(pairs.T.tolist(), counts.tolist())
    }
    gt_area = dict(zip(*np.unique(gk[gk != -1], return_counts=True)))
    pred_area = dict(zip(*np.unique(pk[pk != -1], return_counts=True)))
    crowd_keys = {(int(c) << 32) + int(i) for c, i in gt_crowd}

    iou_sum = np.zeros(num_classes)
    tp = np.zeros(num_classes)
    fp = np.zeros(num_classes)
    fn = np.zeros(num_classes)

    gt_matched = set()
    pred_matched = set()
    for (g, p), inter in inter_map.items():
        if p == -1 or g == -1:
            continue
        if g in crowd_keys:
            continue
        g_cls = g >> 32
        if g_cls != (p >> 32):
            continue
        # union excludes the pred's void overlap (eval_vpq_vspw.py:176-177)
        union = (
            gt_area[g] + pred_area[p] - inter - inter_map.get((-1, p), 0)
        )
        iou = inter / union if union > 0 else 0.0
        if iou > 0.5:
            gt_matched.add(g)
            pred_matched.add(p)
            iou_sum[g_cls] += iou
            tp[g_cls] += 1
    crowd_by_cat = {}
    for g in gt_area:
        if g in gt_matched:
            continue
        if g in crowd_keys:
            crowd_by_cat[g >> 32] = g  # last one wins, like the reference dict
            continue
        fn[g >> 32] += 1
    for p, a in pred_area.items():
        if p in pred_matched:
            continue
        p_cls = p >> 32
        inter = inter_map.get((-1, p), 0)
        if p_cls in crowd_by_cat:
            inter += inter_map.get((crowd_by_cat[p_cls], p), 0)
        if inter / a > 0.5:  # mostly void/crowd: ignored
            continue
        fp[p_cls] += 1
    return iou_sum, tp, fp, fn


def _vpq_video(args):
    (pc, pi), (gc, gi), wlen, num_classes, ignore, crowd = args
    iou_sum = np.zeros(num_classes)
    tp = np.zeros(num_classes)
    fp = np.zeros(num_classes)
    fn = np.zeros(num_classes)
    T = pc.shape[0]
    # videos shorter than the window contribute nothing at this k (reference
    # range(0, len - nframes + 1), eval_vpq_vspw.py:83)
    for s in range(0, T - wlen + 1):
        e = s + wlen
        i, t, f, n = vpq_single_window(
            pc[s:e], pi[s:e], gc[s:e], gi[s:e], num_classes, ignore, crowd
        )
        iou_sum += i
        tp += t
        fp += f
        fn += n
    return iou_sum, tp, fp, fn


def vpq_eval(
    preds: List[Tuple[np.ndarray, np.ndarray]],  # per video (cls, id) (T,H,W)
    gts: List[Tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    windows: Sequence[int] = (1, 2, 4, 6),  # VIPSeg protocol window lengths
    ignore: int = 255,
    num_workers: int = 0,
    gt_crowds: Optional[List[set]] = None,  # per video: {(class, id)} crowd tubes
) -> Dict[str, float]:
    """VPQ over sliding tube windows, verified identical to the reference
    ``eval_vpq_vspw.py`` run as an oracle (tests/test_vpq_reference_parity.py).
    VPQ = mean over the window lengths of the per-class PQ average (classes
    with tp+fp+fn == 0 excluded). ``num_workers > 0`` fans videos out over a
    process pool (the reference scores VPQ with multiprocessing over videos,
    eval_vpq_vspw.py:219-295)."""
    results = {}
    all_vpq = []
    crowds = gt_crowds or [frozenset()] * len(preds)
    for wlen in windows:
        jobs = [
            (p, g, wlen, num_classes, ignore, c)
            for p, g, c in zip(preds, gts, crowds)
        ]
        if num_workers > 0 and len(jobs) > 1:
            import multiprocessing as mp

            with mp.Pool(num_workers) as pool:
                parts = pool.map(_vpq_video, jobs)
        else:
            parts = [_vpq_video(j) for j in jobs]
        iou_sum = sum(p[0] for p in parts)
        tp = sum(p[1] for p in parts)
        fp = sum(p[2] for p in parts)
        fn = sum(p[3] for p in parts)
        denom = tp + fp / 2 + fn / 2
        present = denom > 0
        pq = np.where(present, iou_sum / np.maximum(denom, 1e-9), 0.0)
        vpq = pq[present].mean() if present.any() else 0.0
        results[f"VPQ@{wlen}"] = float(vpq * 100)
        all_vpq.append(vpq)
    results["VPQ"] = float(np.mean(all_vpq) * 100)
    return results


def _miou_confusion(
    preds: List[np.ndarray], gts: List[np.ndarray], num_classes: int, ignore: int
) -> np.ndarray:
    conf = np.zeros((num_classes, num_classes), np.int64)
    for p, g in zip(preds, gts):
        mask = (g != ignore) & (g >= 0) & (g < num_classes)
        label = num_classes * g[mask].astype(np.int64) + p[mask]
        conf += np.bincount(label, minlength=num_classes**2).reshape(
            num_classes, num_classes
        )
    return conf


def miou_eval(
    preds: List[np.ndarray], gts: List[np.ndarray], num_classes: int, ignore: int = 255
) -> float:
    """VSPW mIoU (eval_miou_vspw.py::Evaluator): confusion matrix over
    GT-valid pixels; per-class IoU = diag / (row + col - diag); mean over the
    classes PRESENT IN THE GT only (``isval`` gating — a class predicted but
    absent from the GT contributes its false positives to the present
    classes' unions but not an extra 0 term to the mean). Verified identical
    to the reference script run as an oracle
    (tests/test_vspw_metrics_reference_parity.py)."""
    conf = _miou_confusion(preds, gts, num_classes, ignore).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.diag(conf) / (conf.sum(axis=1) + conf.sum(axis=0) - np.diag(conf))
    isval = conf.sum(axis=1) > 0
    if not isval.any():
        return 0.0
    return float(np.nansum(iou * isval) / isval.sum() * 100)


def vc_eval(
    preds: List[np.ndarray], gts: List[np.ndarray], n: int = 8, ignore: int = 255
) -> float:
    """Video consistency VC_n (eval_vc_vspw.py::get_common): per n-frame
    window, |pixels where gt AND pred are both temporally constant| /
    |pixels where gt is constant| — CONSISTENCY only; the reference does not
    require the prediction to be correct, and does not exclude void. Windows
    start at 0..T-n-1 (the reference drops the final window) and videos with
    T <= n are skipped; the score is the nan-mean of per-window accuracies.
    Verified identical to the reference script run as an oracle
    (tests/test_vspw_metrics_reference_parity.py)."""
    accs = []
    for p, g in zip(preds, gts):
        T = p.shape[0]
        if T <= n:
            continue
        for s in range(0, T - n):
            gw = g[s : s + n]
            pw = p[s : s + n]
            gt_common = np.all(gw == gw[0:1], axis=0)
            pred_common = np.all(pw == pw[0:1], axis=0) & gt_common
            den = gt_common.sum()
            accs.append(pred_common.sum() / den if den > 0 else np.nan)
    if not accs:
        return 0.0
    return float(np.nanmean(accs) * 100)


def stq_eval(
    preds: List[Tuple[np.ndarray, np.ndarray]],
    gts: List[Tuple[np.ndarray, np.ndarray]],
    num_classes: int,
    num_things: int,
    ignore: int = 255,
    things: Optional[Sequence[int]] = None,
) -> Dict[str, float]:
    """Segmentation and Tracking Quality (reference
    utils/segmentation_and_tracking_quality.py::STQuality, the deepmind numpy
    implementation driven by eval_stq_vspw.py). Verified identical to that
    module run as an oracle (tests/test_vspw_metrics_reference_parity.py).

    - SQ (called IoU in the reference): semantic IoU over all frames with
      GT-void rows removed; mean over classes with a nonzero union (present
      in GT or prediction — a different gating than VSPW mIoU!).
    - AQ: over whole-video GT thing tubes g (key = (class, id); GT pixels
      with instance id 0 on a thing class are crowd and excluded), sum over
      prediction tubes p (restricted to thing-class predicted pixels outside
      GT crowd) of (|p∩g| / |g|) · IoU(p, g); AQ = sum of terms / number of
      GT tubes, pooled over videos.
    - STQ = sqrt(AQ · SQ). Thing classes default to ids [0, num_things);
      pass ``things`` for datasets whose thing ids are scattered (the
      reference driver builds ``thing_list_`` from the categories json,
      eval_stq_vspw.py:65-73)."""
    # SQ: (C+1)^2 confusion, extra index = void; remove GT-void rows, keep
    # pred-void column as false negatives (reference result() :244-252)
    C = num_classes
    conf = np.zeros((C + 1, C + 1), np.int64)
    for (pc, _), (gc, _) in zip(preds, gts):
        g = np.where(gc == ignore, C, gc).reshape(-1).astype(np.int64)
        p = np.where(pc == ignore, C, pc).reshape(-1).astype(np.int64)
        conf += np.bincount((C + 1) * g + p, minlength=(C + 1) ** 2).reshape(
            C + 1, C + 1
        )
    conf[C, :] = 0  # removal_matrix: drop GT-void rows
    inter = np.diag(conf).astype(np.float64)
    fps = conf.sum(axis=0) - inter
    fns = conf.sum(axis=1) - inter
    unions = inter + fps + fns
    n_present = np.count_nonzero(unions)
    sq = float(
        np.sum(inter / np.maximum(unions, 1e-15)) / n_present
    ) if n_present else 0.0

    # AQ over whole-video thing tubes
    thing_ids = np.asarray(
        sorted(things) if things is not None else range(num_things), np.int64
    )
    aq_sum = 0.0
    n_tubes = 0
    for (pc, pi), (gc, gi) in zip(preds, gts):
        gt_thing = np.isin(gc, thing_ids)
        gt_crowd = gt_thing & (gi == 0)
        gt_mask = (gt_thing & ~gt_crowd).reshape(-1)
        pred_thing = np.isin(pc, thing_ids)
        pred_mask = (pred_thing & ~gt_crowd).reshape(-1)

        gkey = (gc.astype(np.int64) * (1 << 32) + gi).reshape(-1)
        pkey = (pc.astype(np.int64) * (1 << 32) + pi).reshape(-1)
        gt_ids, gt_areas = np.unique(gkey[gt_mask], return_counts=True)
        if len(gt_ids) == 0:
            continue
        pred_ids, pred_areas = np.unique(pkey[pred_mask], return_counts=True)
        pred_area_map = dict(zip(pred_ids.tolist(), pred_areas.tolist()))
        both = gt_mask & pred_mask
        pairs, counts = np.unique(
            np.stack([gkey[both], pkey[both]]), axis=1, return_counts=True
        )
        inter_by_gt = defaultdict(list)
        for (g, p), c in zip(pairs.T.tolist(), counts.tolist()):
            inter_by_gt[g].append((p, c))
        gt_area_map = dict(zip(gt_ids.tolist(), gt_areas.tolist()))
        for g in gt_ids.tolist():
            ga = gt_area_map[g]
            total = 0.0
            for p, tpa in inter_by_gt.get(g, []):
                fpa = pred_area_map[p] - tpa
                fna = ga - tpa
                total += tpa * (tpa / (tpa + fpa + fna))
            aq_sum += total / ga
            n_tubes += 1
    aq = aq_sum / n_tubes if n_tubes else 0.0
    return {
        "SQ": sq * 100,
        "AQ": aq * 100,
        "STQ": float(np.sqrt(max(aq * sq, 0.0)) * 100),
    }
