"""Slot attention of the DVIS-DAQ cutter's disappearance branch.

Counterpart: ``dvis_plus_tpu/models/daq/slot_attention.py`` (``SlotAttention``
:33, ``SlotCrossAttentionLayer`` :73). One iteration of inverted
cross-attention: each input's weights are a softmax over the slots, then
normalized over the inputs, and each slot takes the weighted mean of the
inputs. The cross-attention layer feeds it the per-slot updates of a
multi-head attention to the frame's queries; residual and post-norm.

``row_valid`` masks dead rows of the fixed-capacity slot table out of both
coupling axes (the softmax over slots and the sum over inputs), as the JAX
module does. The JAX layers without a ``dtype`` (the slot attention's norms
and projections, the layer's closing norm) compute in fp32 whatever the
input's dtype, so these do too; the multi-head attention computes in the
dtype of its queries. Parameter names follow the reference
``DVIS_DAQ/dvis_daq/slot_attention.py`` (``norm_inputs``,
``project_q.{0,1}``, ``project_k``, ``multihead_attn``, ``slot_attn``,
``norm``). ``hard_softmax`` is training only (ROADMAP A14).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from dvis_plus_tpu_torch.models.layers import LayerNorm, Linear
from dvis_plus_tpu_torch.models.segmenter.transformer_decoder import MultiheadAttention


class SlotAttention(nn.Module):
    """Single-iteration slot attention update (no value projection)."""

    def __init__(self, slot_size: int, eps: float = 1e-6):
        super().__init__()
        self.slot_size, self.eps = slot_size, eps
        self.norm_inputs = LayerNorm(slot_size, eps=1e-5)
        self.project_q = nn.Sequential(LayerNorm(slot_size, eps=1e-5), Linear(slot_size, slot_size, bias=False))
        self.project_k = Linear(slot_size, slot_size, bias=False)

    def forward(self, inputs: torch.Tensor, inputs_k: torch.Tensor, slots: torch.Tensor,
                row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """inputs, inputs_k (B, N, C); slots (B, M, C); row_valid (B, N) = (B, M)
        live rows. Returns (B, M, C) in ``inputs``' dtype."""
        k = self.project_k(self.norm_inputs(inputs_k.float()))
        q = self.project_q(slots.float())
        logits = torch.einsum("bnc,bmc->bnm", k, q) * self.slot_size**-0.5
        if row_valid is not None:
            logits = logits.masked_fill(~row_valid[:, None, :], -1e9)
        attn = logits.softmax(dim=-1) + self.eps  # over slots
        if row_valid is not None:
            attn = attn * row_valid[:, :, None].to(attn.dtype)
        attn = attn / attn.sum(dim=1, keepdim=True)  # over inputs
        return torch.einsum("bnm,bnc->bmc", attn.to(inputs.dtype), inputs)


class SlotCrossAttentionLayer(nn.Module):
    """Multi-head attention to the frame's queries, the slot-attention
    redistribution of its outputs, residual and post-norm (fp32 out)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(dim, num_heads)
        self.slot_attn = SlotAttention(dim)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                pos: Optional[torch.Tensor] = None, query_pos: Optional[torch.Tensor] = None,
                slot_query: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tgt (B, M, C) slot features; memory (B, L, C) frame queries;
        additive ``mask`` (B, 1|H, M, L)."""
        if slot_query is None:
            slot_query = tgt
        q = tgt if query_pos is None else tgt + query_pos
        k = memory if pos is None else memory + pos
        # the JAX projections take their queries' dtype and cast keys and values to it
        tgt2 = self.multihead_attn(q, k.to(q.dtype), memory.to(q.dtype), mask)
        updates = self.slot_attn(tgt2, tgt + tgt2, slot_query, row_valid)
        return self.norm((tgt + updates).float())
