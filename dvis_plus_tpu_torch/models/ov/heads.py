"""Open-vocabulary class heads and the geometric ensemble.

Counterpart: ``dvis_plus_tpu/models/ov/heads.py``
(``get_classification_logits`` :22, ``mask_pooling`` :43,
``geometric_ensemble`` :54):

- :func:`get_classification_logits`: cosine logits against the text
  classifier, ``exp(logit_scale)`` clamped at 100, the maximum over each
  class's template rows; the last ``num_templates[-1]`` rows are the void
  block. The JAX op promotes a bf16 embedding times the fp32 classifier to
  fp32; here the product is taken in fp32 the same way;
- :func:`mask_pooling`: mask logits resized bilinearly (no antialias) to the
  feature map, thresholded ``> 0``, features averaged over each mask with a
  +1e-8 guard on the pixel count, in the features' dtype;
- :func:`geometric_ensemble`: fp32 softmaxes, ``alpha`` for the classes
  seen in training and ``beta`` for the others, ``clip(., 1e-20, 1)``, the
  void probability renormalization and ``log(p + 1e-8)``.

Feature maps are NCHW here, NHWC there.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def get_classification_logits(
    x: torch.Tensor,  # (..., C) query embeddings
    text_classifier: torch.Tensor,  # (R, C) class-template rows, then the void rows
    logit_scale: torch.Tensor,  # scalar (log scale)
    num_templates: Sequence[int],  # rows per class; the last entry = void rows
) -> torch.Tensor:
    """(..., K+1) fp32 logits."""
    x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
    t = text_classifier / (torch.linalg.vector_norm(text_classifier, dim=-1, keepdim=True) + 1e-12)
    scale = torch.clamp(logit_scale.float().exp(), max=100.0)
    logits = (scale * x.float()) @ t.float().T  # (..., R)
    outs = []
    cur = 0
    for n in num_templates[:-1]:
        outs.append(logits[..., cur : cur + n].amax(dim=-1))
        cur += n
    outs.append(logits[..., logits.shape[-1] - num_templates[-1] :].amax(dim=-1))
    return torch.stack(outs, dim=-1)


def resize_masks(mask: torch.Tensor, size) -> torch.Tensor:
    """(..., Hm, Wm) -> (..., H, W) bilinear, half-pixel centres, no
    antialias (``jax.image.resize(..., antialias=False)``)."""
    if tuple(mask.shape[-2:]) == tuple(size):
        return mask
    lead = mask.shape[:-2]
    out = F.interpolate(mask.reshape(-1, 1, *mask.shape[-2:]), size=tuple(size), mode="bilinear",
                        align_corners=False)
    return out.reshape(*lead, *size)


def mask_pooling(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) dense features; mask (B, Q, Hm, Wm) logits ->
    (B, Q, C) features averaged over each binary (> 0) mask."""
    m = (resize_masks(mask, x.shape[-2:]) > 0.0).to(x.dtype)  # (B, Q, H, W)
    denom = m.sum(dim=(-1, -2))[..., None] + 1e-8  # (B, Q, 1)
    return torch.einsum("bchw,bqhw->bqc", x, m) / denom


def geometric_ensemble(
    in_vocab_logits: torch.Tensor,  # (..., K+1) with the void column
    out_vocab_logits: torch.Tensor,  # (..., K+1) CLIP-pooled logits with the void column
    category_overlapping: torch.Tensor,  # (K,) 1 = seen in training
    alpha: float = 0.4,
    beta: float = 0.8,
) -> torch.Tensor:
    """Fused log-probabilities (..., K+1). The JAX function's
    ``valid_masking`` argument is passed by no caller there
    (``model.ov.ensemble_on_valid_mask`` is read by nothing), so it has no
    counterpart here."""
    in_soft = in_vocab_logits.float().softmax(dim=-1)
    in_probs = in_soft[..., :-1]
    out_probs = out_vocab_logits.float().softmax(dim=-1)[..., :-1]
    seen = category_overlapping.float()
    log_seen = torch.log(torch.clamp(in_probs ** (1.0 - alpha) * out_probs**alpha, 1e-20, 1.0)) * seen
    log_unseen = torch.log(torch.clamp(in_probs ** (1.0 - beta) * out_probs**beta, 1e-20, 1.0)) * (1.0 - seen)
    cls_results = log_seen + log_unseen  # (..., K)
    is_void = in_soft[..., -1:]
    probs = torch.cat([cls_results.softmax(dim=-1) * (1.0 - is_void), is_void], dim=-1)
    return torch.log(probs + 1e-8)
