"""DVIS++'s temporal refiner at inference, plain.

A frozen copy of the benchmarked package's
``models/refiner/temporal_refiner.py`` over a video of its true length, without
the open-vocabulary head: per layer, temporal self-attention over the frames of
each query, the short-term conv block (conv1d k5 -> relu -> conv1d k3,
replicate padding, residual + LayerNorm), object self-attention over the
queries of each frame, cross-attention to the frame's segmenter queries, FFN;
the class head pools over time with a learned activation softmax, the mask
head is an einsum against the stride-4 mask features.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.decoder import MLP, CrossAttentionLayer, FFNLayer, SelfAttentionLayer
from port_bench.reference.layers import Conv1d, LayerNorm, Linear, einsum


def _edge_pad(y: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([y[..., :1].expand(*y.shape[:-1], n), y,
                      y[..., -1:].expand(*y.shape[:-1], n)], dim=-1)


class TemporalRefiner(nn.Module):
    def __init__(self, num_classes: int, hidden_dim: int, feedforward_dim: int, num_heads: int,
                 num_layers: int, mask_dim: int):
        super().__init__()
        C = hidden_dim
        self.num_layers = num_layers
        self.transformer_time_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(C, num_heads) for _ in range(num_layers))
        self.conv_short_aggregate_layers = nn.ModuleList(
            nn.Sequential(Conv1d(C, C, 5), nn.ReLU(), Conv1d(C, C, 3)) for _ in range(num_layers))
        self.conv_norms = nn.ModuleList(LayerNorm(C, eps=1e-5) for _ in range(num_layers))
        self.transformer_obj_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(C, num_heads) for _ in range(num_layers))
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(C, num_heads) for _ in range(num_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(C, feedforward_dim) for _ in range(num_layers))
        self.decoder_norm = LayerNorm(C, eps=1e-5)
        self.mask_embed = MLP(C, C, mask_dim, 3)
        self.activation_proj = Linear(C, 1)
        self.class_embed = Linear(C, num_classes + 1)

    def _conv_block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        conv1, _, conv2 = self.conv_short_aggregate_layers[i]
        y = F.relu(conv1(_edge_pad(x.transpose(1, 2), 2)))
        y = conv2(_edge_pad(y, 1))
        return self.conv_norms[i](x + y.transpose(1, 2))

    def embed_pass(self, instance_embeds: torch.Tensor, frame_embeds: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        """instance_embeds (B, T, Q, C), frame_embeds (B, T, fQ, C) -> video
        class logits (B, Q, K+1) and the mask-head embeddings (B, T, Q, mask_dim)."""
        B, T, Q, C = instance_embeds.shape
        mem = frame_embeds.reshape(B * T, frame_embeds.shape[2], C)
        output = instance_embeds
        for i in range(self.num_layers):
            x = output.transpose(1, 2).reshape(B * Q, T, C)
            x = self.transformer_time_self_attention_layers[i](x)
            x = self._conv_block(i, x)
            x = x.reshape(B, Q, T, C).transpose(1, 2).reshape(B * T, Q, C)
            x = self.transformer_obj_self_attention_layers[i](x)
            x = self.transformer_cross_attention_layers[i](x, mem, 0.0, 0.0)
            output = self.transformer_ffn_layers[i](x).reshape(B, T, Q, C)
        x = self.decoder_norm(output)
        a = self.activation_proj(x)  # (B, T, Q, 1)
        fused = (x * a.softmax(dim=1)).sum(dim=1, keepdim=True)
        return {"pred_logits": self.class_embed(fused)[:, 0], "mask_embed": self.mask_embed(x),
                "pred_embds": x}

    @staticmethod
    def mask_window(mask_embed: torch.Tensor, mask_features: torch.Tensor) -> torch.Tensor:
        """(B, Tw, Q, Cm) x (B, Tw, Cm, H, W) -> (B, Q, Tw, H, W) fp32 logits."""
        return einsum("btqc,btchw->bqthw", mask_embed.float(), mask_features.float())
