"""Multi-scale deformable attention and the MSDeformAttn pixel decoder, plain.

A frozen copy of the benchmarked package's deformable-attention twin
(``ops/msdeform.py::ms_deform_attn_torch``), its projections and encoder
layer, the pixel decoder and the sine position encoding. Bilinear sampling
is an explicit gather of the four corners (zero padding,
``align_corners=False``), accumulated in fp32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.layers import Conv2d, GroupNorm, LayerNorm, Linear

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor, attention_weights: torch.Tensor) -> torch.Tensor:
    """value (B, Len, M, D), locations (B, Lq, M, L, P, 2) normalized (x, y),
    weights (B, Lq, M, L, P) -> (B, Lq, M*D) in ``value.dtype``."""
    B, _, M, D = value.shape
    Lq, P = sampling_locations.shape[1], sampling_locations.shape[4]
    v = value.float().transpose(1, 2)  # (B, M, Len, D)
    out = torch.zeros(B, M, Lq, D, dtype=torch.float32, device=value.device)
    start = 0
    for lid, (H, W) in enumerate(spatial_shapes):
        v_l = v[:, :, start : start + H * W]
        start += H * W
        loc = sampling_locations[:, :, :, lid].float().transpose(1, 2)  # (B, M, Lq, P, 2)
        a = attention_weights[:, :, :, lid].float().transpose(1, 2)  # (B, M, Lq, P)
        x = loc[..., 0] * W - 0.5
        y = loc[..., 1] * H - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        wx1, wy1 = x - x0, y - y0
        corners = ((y0, x0, (1.0 - wy1) * (1.0 - wx1)), (y0, x0 + 1.0, (1.0 - wy1) * wx1),
                   (y0 + 1.0, x0, wy1 * (1.0 - wx1)), (y0 + 1.0, x0 + 1.0, wy1 * wx1))
        for yc, xc, w in corners:
            valid = (xc >= 0) & (xc < W) & (yc >= 0) & (yc < H)
            idx = (yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)).long()
            g = torch.gather(v_l, 2, idx.reshape(B, M, Lq * P, 1).expand(B, M, Lq * P, D)
                             ).reshape(B, M, Lq, P, D)
            out += (g * (w * valid.float() * a).unsqueeze(-1)).sum(dim=3)
    return out.transpose(1, 2).reshape(B, Lq, M * D).to(value.dtype)


def _sine_embed(coord: torch.Tensor, num_pos_feats: int, temperature: float) -> torch.Tensor:
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=coord.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    pos = coord[..., None] / dim_t
    return torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], dim=-1).reshape(
        *pos.shape[:-1], -1)


def position_embedding_sine_2d(H: int, W: int, num_pos_feats: int, temperature: float = 10000.0,
                               device=None) -> torch.Tensor:
    """(H, W, 2*num_pos_feats), [pos_y, pos_x], normalized to 2 pi."""
    scale, eps = 2.0 * math.pi, 1e-6
    y = torch.arange(1, H + 1, dtype=torch.float32, device=device)[:, None].expand(H, W)
    x = torch.arange(1, W + 1, dtype=torch.float32, device=device)[None, :].expand(H, W)
    y, x = y / (H + eps) * scale, x / (W + eps) * scale
    return torch.cat([_sine_embed(y, num_pos_feats, temperature),
                      _sine_embed(x, num_pos_feats, temperature)], dim=-1)


def reference_points(spatial_shapes: Sequence[Tuple[int, int]], device=None) -> torch.Tensor:
    """(Len, n_levels, 2) pixel-centre reference points (x, y) on every level."""
    refs = []
    for Hl, Wl in spatial_shapes:
        ry = (torch.arange(Hl, dtype=torch.float32, device=device) + 0.5) / Hl
        rx = (torch.arange(Wl, dtype=torch.float32, device=device) + 0.5) / Wl
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
    ref = torch.cat(refs, dim=0)
    return ref[:, None, :].expand(ref.shape[0], len(spatial_shapes), 2)


class MSDeformAttn(nn.Module):
    """The four projections of one deformable attention."""

    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = Linear(d_model, d_model)
        self.output_proj = Linear(d_model, d_model)


def deform_attention(sa: MSDeformAttn, query: torch.Tensor, refs: torch.Tensor, feat: torch.Tensor,
                     spatial_shapes: Sequence[Tuple[int, int]], value_dtype=None) -> torch.Tensor:
    """query (B, Lq, C) attends into feat (B, Len, C); refs (Lq, L, 2). The
    attention weights keep the query's dtype, the locations are fp32, the
    value takes ``value_dtype`` (default: the query's), and so does the result."""
    B, Lq, C = query.shape
    M, L, P = sa.n_heads, sa.n_levels, sa.n_points
    value = sa.value_proj(feat).reshape(B, feat.shape[1], M, C // M)
    if value_dtype is not None:
        value = value.to(value_dtype)
    offsets = sa.sampling_offsets(query).reshape(B, Lq, M, L, P, 2)
    attn = sa.attention_weights(query).reshape(B, Lq, M, L * P).softmax(-1)
    normalizer = torch.tensor([[w, h] for (h, w) in spatial_shapes], dtype=torch.float32,
                              device=query.device)
    locations = refs[None, :, None, :, None, :] + offsets / normalizer[None, None, None, :, None, :]
    out = ms_deform_attn(value, spatial_shapes, locations.float(), attn.reshape(B, Lq, M, L, P))
    return sa.output_proj(out.to(query.dtype))


class MSDeformAttnLayer(nn.Module):
    """Deformable self-attention + FFN, post-norm, computed in ``island_dtype``."""

    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int, n_points: int,
                 value_dtype: str, island_dtype: str):
        super().__init__()
        self.value_dtype, self.island_dtype = dtype_of(value_dtype), dtype_of(island_dtype)
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, refs, spatial_shapes):
        cdt = self.island_dtype
        q = (src + pos[None]).to(cdt)
        out = deform_attention(self.self_attn, q, refs, src.to(cdt), spatial_shapes,
                               value_dtype=self.value_dtype)
        src = self.norm1(src.to(cdt) + out.to(cdt))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class _Encoder(nn.Module):
    def __init__(self, num_layers: int, **kw):
        super().__init__()
        self.layers = nn.ModuleList(MSDeformAttnLayer(**kw) for _ in range(num_layers))


class _Transformer(nn.Module):
    def __init__(self, d_model: int, n_levels: int, num_layers: int, **kw):
        super().__init__()
        self.level_embed = nn.Parameter(torch.zeros(n_levels, d_model))
        self.encoder = _Encoder(num_layers, d_model=d_model, n_levels=n_levels, **kw)


class MSDeformAttnPixelDecoder(nn.Module):
    """{res2..res5} -> (mask features (B, mask_dim, H/4, W/4) fp32, the
    encoder's maps at strides 32, 16, 8 in the input dtype)."""

    def __init__(self, in_channels: Dict[str, int], pd):
        super().__init__()
        C = self.conv_dim = pd.conv_dim
        self.levels = list(pd.transformer_in_features)[::-1]
        self.island_dtype = dtype_of(pd.island_dtype)
        self.input_proj = nn.ModuleList(
            nn.Sequential(Conv2d(in_channels[n], C, 1), GroupNorm(32, C, eps=1e-5))
            for n in self.levels)
        self.transformer = _Transformer(
            C, len(self.levels), pd.transformer_enc_layers, d_ffn=pd.transformer_dim_feedforward,
            n_heads=pd.transformer_nheads, n_points=pd.num_points,
            value_dtype=pd.msdeform_value_dtype, island_dtype=pd.island_dtype)
        self.adapter_1 = Conv2d(in_channels["res2"], C, 1, bias=False,
                                norm=GroupNorm(32, C, eps=1e-5))
        self.layer_1 = Conv2d(C, C, 3, padding=1, bias=False, norm=GroupNorm(32, C, eps=1e-5))
        self.mask_features = Conv2d(C, pd.mask_dim, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        in_dtype = features["res2"].dtype
        cdt = self.island_dtype
        srcs, poss, shapes = [], [], []
        for i, name in enumerate(self.levels):
            x = features[name].to(cdt)
            B, _, Hl, Wl = x.shape
            srcs.append(self.input_proj[i](x).flatten(2).transpose(1, 2))
            pe = position_embedding_sine_2d(Hl, Wl, self.conv_dim // 2, device=x.device)
            poss.append(pe.reshape(Hl * Wl, self.conv_dim) + self.transformer.level_embed[i][None])
            shapes.append((Hl, Wl))
        src, pos = torch.cat(srcs, dim=1), torch.cat(poss, dim=0)
        refs = reference_points(shapes, device=src.device)
        for layer in self.transformer.encoder.layers:
            src = layer(src, pos, refs, shapes)
        out_maps, start = [], 0
        for Hl, Wl in shapes:
            out_maps.append(src[:, start : start + Hl * Wl].transpose(1, 2).reshape(
                B, self.conv_dim, Hl, Wl))
            start += Hl * Wl
        x2 = features["res2"].to(cdt).float()
        top_up = F.interpolate(out_maps[-1], size=x2.shape[-2:], mode="bilinear",
                               align_corners=False)
        y = F.relu(self.layer_1(self.adapter_1(x2) + top_up.float()))
        return self.mask_features(y), [m.to(in_dtype) for m in out_maps]
