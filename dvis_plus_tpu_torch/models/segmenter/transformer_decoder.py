"""Masked-attention transformer decoder (the DVIS++ per-frame query decoder).

Counterpart: ``dvis_plus_tpu/models/segmenter/transformer_decoder.py``
(``MLP`` :37, ``_attention`` :52, ``MultiHeadAttention`` :67, the Self /
Cross / FFN layers :95-148, ``MaskedTransformerDecoder`` :149 with the ReID
MLP). Parameter names follow the reference
``video_mask2former_transformer_decoder.py`` (``query_feat``,
``transformer_cross_attention_layers.{i}.multihead_attn.in_proj_weight``, ...)
so ``state_dict()`` is in the reference checkpoints' key space.

Frames ride the batch dim (BT). Attention is plain matmul + softmax with the
softmax in fp32; the next layer's attention mask is the bilinear resize of
the mask logits (``align_corners=False``, no antialias), blocked where
``sigmoid < 0.5``, with all-blocked rows unblocked, applied as an additive
-1e9. Every layer computes in its input's dtype (``model.compute_dtype``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dvis_plus_tpu_torch.models.layers import Conv2d, LayerNorm, Linear
from dvis_plus_tpu_torch.models.segmenter.position_encoding import position_embedding_sine_2d

_NEG_INF = -1e9


class MLP(nn.Module):
    """n-layer MLP with relu; layers under ``layers.{i}`` as in the reference."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int = 3):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, Lq, Dh), k/v (B, H, Lk, Dh), additive mask (B, 1|H, Lq, Lk).
    Scores and softmax in fp32, the weighted sum in v's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = logits + mask
    w = logits.softmax(dim=-1).to(v.dtype)
    return torch.matmul(w, v)


class MultiheadAttention(nn.Module):
    """Torch-style MHA with a fused ``in_proj_weight`` (3C, C) and an
    ``out_proj`` Linear, the key space of ``nn.MultiheadAttention``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, q, k, v, mask=None):
        B, Lq, C = q.shape
        H = self.num_heads
        w = self.in_proj_weight.to(q.dtype)
        b = self.in_proj_bias.to(q.dtype)

        def proj(x, i):
            y = F.linear(x, w[i * C : (i + 1) * C], b[i * C : (i + 1) * C])
            return y.reshape(B, x.shape[1], H, C // H).transpose(1, 2)

        out = attention(proj(q, 0), proj(k, 1), proj(v, 2), mask)  # (B, H, Lq, Dh)
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, C))


class SelfAttentionLayer(nn.Module):
    """Post-norm self-attention over queries. ``kv`` replaces the keys and
    values (the object-sharded refiner: a shard's queries against every
    shard's, ``parallel/sp.py``)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, tgt, query_pos=None, mask=None, kv=None):
        q = tgt if query_pos is None else tgt + query_pos
        k, v = (q, tgt) if kv is None else (kv, kv)
        return self.norm(tgt + self.self_attn(q, k, v, mask))


class CrossAttentionLayer(nn.Module):
    """Post-norm cross-attention to pixel features."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(dim, num_heads)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, tgt, memory, pos, query_pos, mask=None):
        out = self.multihead_attn(tgt + query_pos, memory + pos, memory, mask)
        return self.norm(tgt + out)


class FFNLayer(nn.Module):
    """Post-norm FFN."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.linear1 = Linear(dim, hidden_dim)
        self.linear2 = Linear(hidden_dim, dim)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, tgt):
        return self.norm(tgt + self.linear2(F.relu(self.linear1(tgt))))


class MaskedTransformerDecoder(nn.Module):
    """Per-frame masked-attention decoder emitting query embeddings; with
    ``reid_branch`` the embeddings are concat(decoder-normed, ReID MLP)."""

    def __init__(self, num_classes: int, in_channels: int = 256, hidden_dim: int = 256,
                 num_queries: int = 100, num_heads: int = 8, dim_feedforward: int = 2048,
                 num_layers: int = 9, num_levels: int = 3, mask_dim: int = 256,
                 reid_branch: bool = False, reid_hidden_dim: int = 512,
                 num_reid_layers: int = 3):
        super().__init__()
        C = hidden_dim
        self.hidden_dim = C
        self.num_layers, self.num_levels = num_layers, num_levels
        self.level_embed = nn.Embedding(num_levels, C)
        self.query_feat = nn.Embedding(num_queries, C)
        self.query_embed = nn.Embedding(num_queries, C)
        self.input_proj = nn.ModuleList(
            nn.Identity() if in_channels == C else Conv2d(in_channels, C, 1)
            for _ in range(num_levels)
        )
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(C, num_heads) for _ in range(num_layers)
        )
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(C, num_heads) for _ in range(num_layers)
        )
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(C, dim_feedforward) for _ in range(num_layers)
        )
        self.decoder_norm = LayerNorm(C, eps=1e-5)
        self.class_embed = Linear(C, num_classes + 1)
        self.mask_embed = MLP(C, C, mask_dim, 3)
        self.reid_embed = (
            MLP(C, reid_hidden_dim, C, num_reid_layers) if reid_branch else None
        )

    def _prediction_heads(self, output, mask_features, attn_size):
        """(normed queries, mask logits (BT, Q, H4, W4) fp32, the next
        layer's additive attention mask (BT, 1, Q, h·w))."""
        x = self.decoder_norm(output)
        memb = self.mask_embed(x)
        masks = torch.einsum("bqc,bchw->bqhw", memb.float(), mask_features.float())
        am = F.interpolate(masks, size=attn_size, mode="bilinear", align_corners=False)
        blocked = am.flatten(2).sigmoid() < 0.5  # (BT, Q, HW)
        blocked = blocked & ~blocked.all(dim=-1, keepdim=True)
        additive = torch.zeros(blocked.shape, dtype=torch.float32, device=blocked.device)
        additive = additive.masked_fill(blocked, _NEG_INF)[:, None]  # (BT, 1, Q, HW)
        return x, masks, additive

    def _class_head(self, x, masks, mask_features, **classifier):
        """Class logits of the normed queries ``x``; only the last layer's
        are returned, so only they are computed (the JAX module's earlier
        layers' logits are auxiliary outputs the eval path drops)."""
        return self.class_embed(x)

    def forward(self, multi_scale: Sequence[torch.Tensor], mask_features: torch.Tensor,
                aux: bool = False, **classifier) -> Dict[str, torch.Tensor]:
        """multi_scale: 3 x (BT, C, H_l, W_l), strides 32, 16, 8;
        mask_features: (BT, mask_dim, H4, W4); ``classifier``: keyword
        arguments of the class head (the open-vocabulary one's text
        classifier). ``aux``: also every earlier prediction's logits and
        masks, ``aux_pred_logits`` / ``aux_pred_masks`` (the JAX module's
        lists: the queries' initial prediction, then each layer's but the
        last), which the training losses supervise."""
        BT = multi_scale[0].shape[0]
        C = self.hidden_dim
        dtype = multi_scale[0].dtype
        srcs, poss, sizes = [], [], []
        for i, x in enumerate(multi_scale):
            Hl, Wl = x.shape[-2:]
            proj = self.input_proj[i](x)
            srcs.append(
                proj.flatten(2).transpose(1, 2) + self.level_embed.weight[i].to(dtype)[None, None]
            )
            pe = position_embedding_sine_2d(Hl, Wl, C // 2, device=x.device)
            poss.append(pe.reshape(1, Hl * Wl, C).to(dtype))
            sizes.append((Hl, Wl))

        output = self.query_feat.weight[None].expand(BT, -1, -1).to(dtype)
        qpos = self.query_embed.weight[None].expand(BT, -1, -1).to(dtype)
        x, masks, attn_mask = self._prediction_heads(output, mask_features, sizes[0])
        aux_logits, aux_masks = [], []
        for i in range(self.num_layers):
            if aux:
                aux_logits.append(self._class_head(x, masks, mask_features, **classifier))
                aux_masks.append(masks)
            li = i % self.num_levels
            output = self.transformer_cross_attention_layers[i](
                output, srcs[li], poss[li], qpos, attn_mask
            )
            output = self.transformer_self_attention_layers[i](output, qpos)
            output = self.transformer_ffn_layers[i](output)
            x, masks, attn_mask = self._prediction_heads(
                output, mask_features, sizes[(i + 1) % self.num_levels]
            )
        logits = self._class_head(x, masks, mask_features, **classifier)

        embds = x
        out = {
            "pred_logits": logits,
            "pred_masks": masks,
            "pred_embds_without_norm": output,
            "pred_embds": embds,
            "mask_features": mask_features,
        }
        if aux:
            out["aux_pred_logits"], out["aux_pred_masks"] = aux_logits, aux_masks
        if self.reid_embed is not None:
            reid = self.reid_embed(embds)
            out["pred_reid_embed"] = reid
            out["pred_embds"] = torch.cat([embds, reid], dim=-1)
            out["pred_embds_without_norm"] = torch.cat([output, reid], dim=-1)
        return out
