"""DVIS++'s referring tracker at inference, plain.

A frozen copy of the benchmarked package's
``models/tracker/referring_tracker.py`` without the training noise and the
open-vocabulary head: per frame, the segmenter's queries are aligned to the
previous frame's by a cosine-cost auction, then ``num_layers`` x [referring
cross-attention -> self-attention -> FFN]; the class head reads
concat(reference, output).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from port_bench.reference.auction import auction_lap
from port_bench.reference.decoder import MLP, FFNLayer, MultiheadAttention, SelfAttentionLayer
from port_bench.reference.layers import Conv2d, LayerNorm, Linear, einsum


class TrackerState(NamedTuple):
    last_output: torch.Tensor  # (B, Q, C)
    last_frame_embeds: torch.Tensor  # (B, Q, C)
    is_first: bool


def init_tracker_state(B: int, Q: int, C: int, dtype=torch.float32, device=None) -> TrackerState:
    z = torch.zeros(B, Q, C, dtype=dtype, device=device)
    return TrackerState(z, z, True)


def match_embds(ref: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """(B, Q, C) x (B, Q, C) -> (B, Q): the current query aligned to each reference slot."""
    ref_n = ref / (torch.linalg.norm(ref, dim=-1, keepdim=True) + 1e-6)
    cur_n = cur / (torch.linalg.norm(cur, dim=-1, keepdim=True) + 1e-6)
    C = 1.0 - cur_n @ ref_n.transpose(-1, -2)
    C = torch.where(torch.isnan(C), torch.zeros_like(C), C).transpose(-1, -2).float()
    if C.device.type == "meta":  # counting operations: no assignment to solve
        return torch.arange(C.shape[-1], device=C.device).expand(C.shape[:-1])
    return auction_lap(C)


class ReferringCrossAttentionLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(dim, num_heads)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, identity, tgt, key, memory):
        return self.norm(identity + self.multihead_attn(tgt, key, memory))


class ReferringTracker(nn.Module):
    def __init__(self, num_classes: int, hidden_dim: int, feedforward_dim: int, num_heads: int,
                 num_layers: int, mask_dim: int, mask_in_dim: int):
        super().__init__()
        C = hidden_dim
        self.num_layers = num_layers
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(C, num_heads) for _ in range(num_layers))
        self.transformer_cross_attention_layers = nn.ModuleList(
            ReferringCrossAttentionLayer(C, num_heads) for _ in range(num_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(C, feedforward_dim) for _ in range(num_layers))
        self.ref_proj = MLP(C, C, C, 3)
        self.decoder_norm = LayerNorm(C, eps=1e-5)
        self.mask_embed = MLP(C, C, mask_dim, 3)
        self.class_embed = Linear(2 * C, num_classes + 1)
        self.mask_feature_proj = Conv2d(mask_in_dim, mask_dim, 1)

    def frame_step(self, state: TrackerState, cur: torch.Tensor, cur_nn: torch.Tensor):
        first = state.is_first
        with torch.no_grad():
            idx = match_embds(cur if first else state.last_frame_embeds, cur)
        gather = lambda x: torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))  # noqa: E731
        init, aligned = gather(cur_nn).to(cur.dtype), gather(cur)
        reference = self.ref_proj(cur_nn if first else state.last_output)
        output = init
        for j in range(self.num_layers):
            if j == 0:
                identity, tgt = init, reference
            else:
                identity = output
                tgt = self.ref_proj(output) if first else reference
            output = self.transformer_cross_attention_layers[j](identity, tgt, cur_nn, cur_nn)
            output = self.transformer_self_attention_layers[j](output)
            output = self.transformer_ffn_layers[j](output)
        return output, reference, idx, TrackerState(output, aligned, False)

    def forward(self, frame_embeds, mask_features, frame_embeds_no_norm, state: TrackerState,
                predict_masks: bool = True):
        """frame_embeds / frame_embeds_no_norm (B, T, Q, C), mask_features
        (B, T, mask_in_dim, H, W). Returns ({"pred_embds", "pred_logits",
        "indices"[, "pred_masks"]}, state)."""
        B, T, Q, C = frame_embeds.shape
        dtype = frame_embeds.dtype
        state = TrackerState(state.last_output.to(dtype), state.last_frame_embeds.to(dtype),
                             state.is_first)
        outputs, references, indices = [], [], []
        for t in range(T):
            out_t, ref_t, idx_t, state = self.frame_step(state, frame_embeds[:, t],
                                                         frame_embeds_no_norm[:, t])
            outputs.append(out_t)
            references.append(ref_t)
            indices.append(idx_t)
        emit = torch.stack(outputs, dim=1)  # (B, T, Q, C)
        refs = torch.stack(references, dim=1)
        x = self.decoder_norm(emit)
        out = {"pred_embds": emit, "indices": torch.stack(indices, dim=1),
               "pred_logits": self.class_embed(torch.cat([refs, x], dim=-1))}
        if predict_masks:
            mf = self.mask_feature_proj(mask_features.flatten(0, 1))
            mf = mf.reshape(B, T, *mf.shape[1:])
            out["pred_masks"] = einsum("btqc,btchw->bqthw", self.mask_embed(x).float(),
                                             mf.float())
        return out, state
