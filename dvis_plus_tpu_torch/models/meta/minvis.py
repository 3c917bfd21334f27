"""Video post-processing shared by the VIS heads: flat top-K and two-stage
mask upsampling.

Counterpart: ``dvis_plus_tpu/models/meta/minvis.py`` (``topk_select`` :157,
``upsample_masks`` :178).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def topk_select(
    mask_cls: torch.Tensor,  # (Q, K+1)
    topk: int,
    aux_pred_cls: Optional[torch.Tensor] = None,  # (Q, K+1)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat top-K over the (Q x K) score matrix. Returns (scores, labels,
    query indices), each (topk,). ``aux_pred_cls``: element-wise max of the
    two softmaxes, no renormalization. Among equal scores the lower flat
    index comes first, as ``jax.lax.top_k`` orders them: a stable descending
    sort, the same on the CPU and on the card (``torch.topk`` fixes no order
    among ties, and equal scores are real: a saturated softmax is exactly
    1.0)."""
    Q, K1 = mask_cls.shape
    K = K1 - 1
    topk = min(topk, Q * K)
    scores = mask_cls.float().softmax(-1)[:, :-1]
    if aux_pred_cls is not None:
        scores = torch.maximum(scores, aux_pred_cls.float().softmax(-1)[:, :-1])
    top_scores, top_idx = torch.sort(scores.reshape(-1), descending=True, stable=True)
    top_scores, top_idx = top_scores[:topk], top_idx[:topk]
    return top_scores, top_idx % K, torch.div(top_idx, K, rounding_mode="floor")


def upsample_masks(
    masks: torch.Tensor,  # (N, t, H4, W4) mask logits
    img_size: Tuple[int, int],
    output_size: Tuple[int, int],
    padded_size: Tuple[int, int],
) -> torch.Tensor:
    """Resize to the padded model input, crop the valid region, resize to the
    original resolution; returns (N, t, out_h, out_w) bool (> 0).

    ``jax.image.resize`` antialiases by default: on upsampling that is plain
    bilinear interpolation, on downsampling a triangle filter widened by the
    scale. The first stage always upsamples; the second gets
    ``antialias=True``, which is PyTorch's form of the same filter (and plain
    bilinear along any axis that upsamples)."""
    masks = masks.float()
    masks = F.interpolate(masks, size=tuple(padded_size), mode="bilinear", align_corners=False)
    masks = masks[:, :, : img_size[0], : img_size[1]]
    masks = F.interpolate(
        masks, size=tuple(output_size), mode="bilinear", align_corners=False, antialias=True
    )
    return masks > 0.0
