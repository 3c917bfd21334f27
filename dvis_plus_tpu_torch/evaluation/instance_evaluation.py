"""COCO-style image instance evaluation and semantic test-time augmentation.

Counterpart: ``dvis_plus_tpu/evaluation/instance_evaluation.py``
(``evaluate_instances`` :22, ``semantic_tta`` :51), which re-designs the
reference ``InstanceSegEvaluator`` and ``SemanticSegmentorWithTTA``:

- image instance AP is the video scorer on one-frame tracks (the
  spatio-temporal tube IoU is the mask IoU at T=1);
- semantic TTA averages class probabilities over a horizontal flip and a set
  of scales.

No entry point of either package calls them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np

from dvis_plus_tpu_torch.evaluation.ytvos_eval import evaluate_vis


def evaluate_instances(
    gt_annotations: List[dict],  # {image_id, category_id, segmentation, iscrowd}
    predictions: List[dict],  # {image_id, category_id, score, segmentation}
    max_dets: int = 100,
) -> Dict[str, float]:
    """Image instance AP through the T=1 video protocol."""
    gts = [{"video_id": g["image_id"], "category_id": g["category_id"],
            "segmentations": [g["segmentation"]], "iscrowd": g.get("iscrowd", 0)}
           for g in gt_annotations]
    dts = [{"video_id": d["image_id"], "category_id": d["category_id"], "score": d["score"],
            "segmentations": [d["segmentation"]]}
           for d in predictions]
    image_ids = {g["video_id"]: 1 for g in gts}
    image_ids.update({d["video_id"]: 1 for d in dts})
    return evaluate_vis(gts, dts, image_ids, max_dets=max_dets)


def semantic_tta(
    predict_probs: Callable[[np.ndarray], np.ndarray],
    image: np.ndarray,  # (H, W, 3)
    scales: Sequence[float] = (1.0,),
    flip: bool = True,
) -> np.ndarray:
    """Class probabilities (H, W, K) averaged over the flips and scales:
    ``predict_probs`` maps an image to its (h, w, K) probabilities; a
    flipped prediction is flipped back and a scaled one resized (bilinear)
    to (H, W)."""
    import cv2

    H, W = image.shape[:2]
    acc = None
    n = 0
    for s in scales:
        img = image if s == 1.0 else cv2.resize(image, (int(W * s), int(H * s)),
                                                interpolation=cv2.INTER_LINEAR)
        for flipped in ((False, True) if flip else (False,)):
            p = predict_probs(np.ascontiguousarray(img[:, ::-1] if flipped else img))
            if flipped:
                p = p[:, ::-1]
            if p.shape[:2] != (H, W):
                p = cv2.resize(p, (W, H), interpolation=cv2.INTER_LINEAR)
            acc = p if acc is None else acc + p
            n += 1
    return acc / n
