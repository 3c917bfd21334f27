"""Vanilla DETR encoder-decoder transformer (the legacy path of the
reference's ``TransformerEncoderPixelDecoder`` MaskFormer variant).

Counterpart: ``dvis_plus_tpu/models/segmenter/detr_transformer.py``
(``DETRTransformer`` :24), which re-designs the reference
``mask2former/modeling/transformer_decoder/transformer.py``. Post-norm
layers, as the JAX module's ``SelfAttentionLayer`` / ``CrossAttentionLayer``
/ ``FFNLayer``. Parameter names follow the reference ``Transformer``:
``encoder.layers.{i}.{self_attn,norm1,linear1,linear2,norm2}``,
``decoder.layers.{i}.{self_attn,norm1,multihead_attn,norm2,linear1,linear2,
norm3}`` and the decoder's shared ``decoder.norm``. No shipped
configuration builds it, in either package.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dvis_plus_tpu_torch.models.layers import LayerNorm, Linear
from dvis_plus_tpu_torch.models.segmenter.transformer_decoder import MultiheadAttention


class EncoderLayer(nn.Module):
    """Post-norm self-attention (q = k = x + pos, v = x) then FFN: the JAX
    ``SelfAttentionLayer`` + ``FFNLayer`` pair."""

    def __init__(self, dim: int, num_heads: int, d_ffn: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.linear1 = Linear(dim, d_ffn)
        self.linear2 = Linear(d_ffn, dim)
        self.norm2 = LayerNorm(dim, eps=1e-5)

    def ffn(self, x: torch.Tensor, norm: nn.Module) -> torch.Tensor:
        return norm(x + self.linear2(F.relu(self.linear1(x))))

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        q = x + pos
        x = self.norm1(x + self.self_attn(q, q, x))
        return self.ffn(x, self.norm2)


class DecoderLayer(EncoderLayer):
    """Post-norm self-attention over the queries, cross-attention to the
    memory (q = tgt + query pos, k = memory + pos, v = memory), FFN."""

    def __init__(self, dim: int, num_heads: int, d_ffn: int):
        super().__init__(dim, num_heads, d_ffn)
        self.multihead_attn = MultiheadAttention(dim, num_heads)
        self.norm3 = LayerNorm(dim, eps=1e-5)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor, pos: torch.Tensor,
                query_pos: torch.Tensor) -> torch.Tensor:
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory))
        return self.ffn(tgt, self.norm3)


class DETRTransformer(nn.Module):
    """Encoder over flattened features plus a decoder over learned queries,
    starting from zeros. Returns (the decoder's outputs, each through the
    shared ``decoder.norm``, (L, B, Q, C) or (1, B, Q, C) without
    ``return_intermediate``; the encoded memory (B, L, C))."""

    def __init__(self, d_model: int = 256, num_heads: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 2048,
                 return_intermediate: bool = True):
        super().__init__()
        self.return_intermediate = return_intermediate
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            EncoderLayer(d_model, num_heads, dim_feedforward) for _ in range(num_encoder_layers))
        self.decoder = nn.Module()
        self.decoder.layers = nn.ModuleList(
            DecoderLayer(d_model, num_heads, dim_feedforward) for _ in range(num_decoder_layers))
        self.decoder.norm = LayerNorm(d_model, eps=1e-5)

    def forward(self, src: torch.Tensor, pos: torch.Tensor,
                query_embed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """src (B, L, C) flattened features; pos (B | 1, L, C); query_embed
        (Q, C) learned query positions."""
        B, L, C = src.shape
        pos = pos.expand(B, L, C).to(src.dtype)
        memory = src
        for layer in self.encoder.layers:
            memory = layer(memory, pos)
        qpos = query_embed[None].expand(B, -1, -1).to(src.dtype)
        tgt = torch.zeros_like(qpos)
        inter = []
        for layer in self.decoder.layers:
            tgt = layer(tgt, memory, pos, qpos)
            inter.append(self.decoder.norm(tgt))
        outs = torch.stack(inter) if self.return_intermediate else inter[-1][None]
        return outs, memory
