"""The FC-CLIP query decoder: the per-frame masked-attention decoder with a
class head in CLIP space.

Counterpart: ``dvis_plus_tpu/models/ov/ov_decoder.py`` (``OVClassHead`` :31,
``OVMaskedTransformerDecoder`` :58). The decoder layers, mask head and
attention masks are the port's per-frame decoder's; the class head pools
the mask features under each query's mask (binary, ``> 0``), normalizes and
projects them (``_mask_pooling_proj`` = LayerNorm + Linear), adds the normed
query, maps the sum into CLIP space (``class_embed``, a 3-layer MLP) and
scores it against the text classifier
(``heads.get_classification_logits`` with this head's own
``logit_scale``). Names follow the reference
``video_mask2former_transformer_decoder_ov.py`` (``zoo_convert.py::_ov_head``,
``convert_ov_decoder``); the tracker and refiner carry structurally equal
heads under their own prefixes.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from dvis_plus_tpu_torch.models.layers import LayerNorm, Linear
from dvis_plus_tpu_torch.models.ov.heads import get_classification_logits, mask_pooling
from dvis_plus_tpu_torch.models.segmenter.transformer_decoder import MLP, MaskedTransformerDecoder


def add_ov_head(module: nn.Module, pooled_dim: int, hidden_dim: int, clip_embed_dim: int) -> None:
    """Register the FC-CLIP class head's parameters on ``module`` under the
    reference names: ``_mask_pooling_proj.{0,1}`` (LayerNorm over the pooled
    ``pooled_dim`` channels, Linear to ``hidden_dim``), ``class_embed`` (MLP
    into CLIP space) and ``logit_scale``."""
    module._mask_pooling_proj = nn.Sequential(LayerNorm(pooled_dim, eps=1e-5),
                                              Linear(pooled_dim, hidden_dim))
    module.class_embed = MLP(hidden_dim, hidden_dim, clip_embed_dim, 3)
    module.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))


def ov_head_logits(module: nn.Module, pooled: torch.Tensor, query: torch.Tensor,
                   text_classifier: torch.Tensor, num_templates: Sequence[int]) -> torch.Tensor:
    """The head of :func:`add_ov_head`: mask-pooled features (..., Cm) and the
    query term (..., C) -> (..., K+1) fp32 logits. The pooled features take
    the query's dtype first, as in the JAX module."""
    pooled = module._mask_pooling_proj(pooled.to(query.dtype))
    return get_classification_logits(module.class_embed(pooled + query), text_classifier,
                                     module.logit_scale, num_templates)


class OVMaskedTransformerDecoder(MaskedTransformerDecoder):
    """Per-frame decoder whose class head scores in CLIP space; no ReID
    branch. ``forward(multi_scale, mask_features, text_classifier=...,
    num_templates=...)``."""

    def __init__(self, clip_embed_dim: int = 768, mask_dim: int = 256, **widths):
        super().__init__(num_classes=0, mask_dim=mask_dim, **widths)
        add_ov_head(self, mask_dim, self.hidden_dim, clip_embed_dim)

    def _class_head(self, x, masks, mask_features, text_classifier=None, num_templates=None):
        pooled = mask_pooling(mask_features, masks)  # (BT, Q, Cm)
        return ov_head_logits(self, pooled, x, text_classifier, num_templates)
