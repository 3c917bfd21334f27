"""Score VPS / VSS evaluator output trees against on-disk ground truth.

Counterpart: ``dvis_plus_tpu/evaluation/offline_scoring.py`` (``read_label_map``
:25, ``score_vps`` :59, ``score_vss`` :118), copied with the port's own
imports. The reference scores these tasks with standalone scripts after the
eval (``eval_vpq_vspw.py``, ``eval_stq_vspw.py``, ``eval_miou_vspw.py``,
``eval_vc_vspw.py``); here the same workflows are a library, which the VPS
and VSS evaluators call when ground truth is on disk, on top of the scorers
of :mod:`.video_metrics`. Label maps are read with OpenCV, imported inside
the calls.
"""
from __future__ import annotations

import json
import os

import numpy as np

from dvis_plus_tpu_torch.evaluation.video_metrics import (
    miou_eval,
    stq_eval,
    vc_eval,
    vpq_eval,
)


def read_label_map(path: str) -> np.ndarray:
    """Panoptic RGB PNG -> int label map (id = R + 256 G + 65536 B)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    img = img[:, :, ::-1].astype(np.int64)  # BGR -> RGB
    return img[..., 0] + img[..., 1] * 256 + img[..., 2] * 65536


def _video_maps(video_anno: dict, png_dir: str, ins_num: dict, cat_map: dict):
    """One video's (cls, id) (T, H, W) maps + crowd tube keys from per-frame
    ``segments_info`` + RGB id PNGs. ``ins_num``: persistent label->index
    numbering in first-seen order (eval_stq_vspw.py:108-126). ``cat_map``:
    dataset category id -> dense scorer class index."""
    cls_frames, id_frames, crowd = [], [], set()
    for frame in video_anno["annotations"]:
        lab = read_label_map(os.path.join(png_dir, frame["file_name"]))
        cls_m = np.full(lab.shape, 255, np.int64)
        id_m = np.full(lab.shape, 255, np.int64)
        for seg in frame["segments_info"]:
            sel = lab == seg["id"]
            if seg["id"] not in ins_num:
                ins_num[seg["id"]] = len(ins_num)
            cls_m[sel] = cat_map[seg["category_id"]]
            id_m[sel] = ins_num[seg["id"]]
            if seg.get("iscrowd", 0):
                crowd.add((cat_map[seg["category_id"]], ins_num[seg["id"]]))
        cls_frames.append(cls_m)
        id_frames.append(id_m)
    return np.stack(cls_frames), np.stack(id_frames), crowd


def score_vps(
    pred_dir: str,
    gt_json: str,
    gt_dir: str,
    windows=(1, 2, 4, 6),
    num_workers: int = 0,
) -> dict:
    """VPQ (per window + mean) and STQ/AQ/SQ for a ``VPSEvaluator`` output
    directory (``pred.json`` + ``pan_pred/``) against VIPSeg-style GT
    (panoptic json + RGB ``panomasksRGB``). Mirrors the reference
    ``eval_vpq_vspw.py`` / ``eval_stq_vspw.py`` drivers (crowd from
    ``iscrowd``; per-video first-seen instance numbering from 0 — which
    makes the first-listed thing tube crowd-excluded in STQ, exactly like
    the reference driver)."""
    with open(gt_json) as f:
        gt = json.load(f)
    with open(os.path.join(pred_dir, "pred.json")) as f:
        pred = json.load(f)
    pred_by_vid = {a["video_id"]: a for a in pred["annotations"]}

    categories = gt["categories"]
    num_classes = len(categories)
    cat_map = {c["id"]: i for i, c in enumerate(categories)}
    known = set(cat_map)
    things = [cat_map[c["id"]] for c in categories if c.get("isthing", 0)]
    for anno in pred["annotations"]:
        for frame in anno["annotations"]:
            for seg in frame["segments_info"]:
                if seg["category_id"] not in known:
                    # reference sanity check (eval_vpq_vspw.py:119-120)
                    raise KeyError(
                        f"video {anno['video_id']}: segment {seg['id']} has "
                        f"unknown category_id {seg['category_id']}"
                    )

    preds, gts, gt_crowds = [], [], []
    for ganno in gt["annotations"]:
        vid = ganno["video_id"]
        if vid not in pred_by_vid:
            raise KeyError(f"video {vid} missing from {pred_dir}/pred.json")
        gc, gi, crowd = _video_maps(ganno, os.path.join(gt_dir, vid), {}, cat_map)
        pc, pi, _ = _video_maps(
            pred_by_vid[vid], os.path.join(pred_dir, "pan_pred", vid), {}, cat_map
        )
        if pc.shape != gc.shape:
            raise ValueError(f"{vid}: pred {pc.shape} vs gt {gc.shape}")
        gts.append((gc, gi))
        preds.append((pc, pi))
        gt_crowds.append(crowd)

    res = vpq_eval(
        preds, gts, num_classes, windows=windows,
        num_workers=num_workers, gt_crowds=gt_crowds,
    )
    res.update(stq_eval(preds, gts, num_classes, num_things=0, things=things))
    res["videos"] = len(gts)
    return res


def score_vss(
    pred_dir: str,
    gt_root: str,
    split: str = "val",
    num_classes: int = 124,
    vc_clips=(8, 16),
) -> dict:
    """mIoU and VC_n for a ``VSSEvaluator`` output directory (per-video
    semantic PNG dirs) against raw VSPW GT masks. Mirrors the reference
    ``eval_miou_vspw.py`` (GT shifted by ``_vspw_preprocess``; predictions
    compared as written) and ``eval_vc_vspw.py`` (raw maps, consistency
    only)."""
    import cv2

    from dvis_plus_tpu_torch.data.datasets.vps_vss import vspw_preprocess

    with open(os.path.join(gt_root, f"{split}.txt")) as f:
        videos = [ln.strip() for ln in f if ln.strip()]

    preds, gts_raw, gts_shifted = [], [], []
    for vid in videos:
        mask_dir = os.path.join(gt_root, "data", vid, "mask")
        p_frames, g_frames = [], []
        for name in sorted(os.listdir(mask_dir)):
            g = cv2.imread(os.path.join(mask_dir, name), cv2.IMREAD_GRAYSCALE)
            p = cv2.imread(os.path.join(pred_dir, vid, name), cv2.IMREAD_GRAYSCALE)
            if p is None:
                raise FileNotFoundError(os.path.join(pred_dir, vid, name))
            g_frames.append(g.astype(np.int64))
            p_frames.append(p.astype(np.int64))
        preds.append(np.stack(p_frames))
        gts_raw.append(np.stack(g_frames))
        gts_shifted.append(vspw_preprocess(np.stack(g_frames)))

    res = {"mIoU": miou_eval(preds, gts_shifted, num_classes), "videos": len(videos)}
    for n in vc_clips:
        # the reference VC script compares RAW maps (no label shift); only
        # temporal self-equality matters, so the shift is irrelevant for GT —
        # but stay byte-faithful to eval_vc_vspw.py and use raw
        res[f"VC{n}"] = vc_eval(preds, gts_raw, n=n)
    return res
