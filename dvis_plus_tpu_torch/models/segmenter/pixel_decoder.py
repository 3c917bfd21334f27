"""MSDeformAttn pixel decoder: a multi-scale deformable-attention encoder over
{res3, res4, res5} plus FPN fusion down to stride-4 mask features.

Counterpart: ``dvis_plus_tpu/models/segmenter/pixel_decoder.py``
(``MSDeformAttnLayer`` :49, ``_reference_points`` :133, ``GroupNormConv``
:146, ``MSDeformAttnPixelDecoder`` :214). Feature maps are NCHW; token
sequences (B, Len, C) as there. Parameter names follow the reference
``msdeformattn.py`` (``input_proj.{i}.{0,1}``, ``transformer.level_embed``,
``transformer.encoder.layers.{i}.self_attn.*``, ``adapter_1``, ``layer_1``,
``mask_features``).

The encoder is an fp32 island (``island_dtype``), as the reference's
``@autocast(enabled=False)``. ``msdeform_impl`` keeps the JAX knob's values:
``exact`` samples unclamped, ``pallas_local`` clamps every location to +-7
value-level pixels around its reference point; both run the same CUDA
kernel on the card (``ops/msdeform.py``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dvis_plus_tpu_torch.models.layers import Conv2d, GroupNorm, LayerNorm, Linear
from dvis_plus_tpu_torch.models.segmenter.position_encoding import position_embedding_sine_2d
from dvis_plus_tpu_torch.ops.msdeform import ms_deform_attn

LOCAL_RADIUS = 7  # ms_deform_attn_local's default clamp radius

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


class MSDeformAttn(nn.Module):
    """Projections of one deformable attention (reference
    ``ops/modules/ms_deform_attn.py``); init as its ``_reset_parameters``."""

    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = Linear(d_model, d_model)
        self.output_proj = Linear(d_model, d_model)
        self._reset_parameters()

    @torch.no_grad()
    def _reset_parameters(self):
        M, L, P = self.n_heads, self.n_levels, self.n_points
        nn.init.zeros_(self.sampling_offsets.weight)
        thetas = torch.arange(M, dtype=torch.float32) * (2.0 * math.pi / M)
        grid = torch.stack([thetas.cos(), thetas.sin()], -1)
        grid = grid / grid.abs().max(-1, keepdim=True).values
        grid = grid[:, None, None, :].repeat(1, L, P, 1)
        grid = grid * torch.arange(1, P + 1, dtype=torch.float32)[None, None, :, None]
        self.sampling_offsets.bias.copy_(grid.reshape(-1))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        for lin in (self.value_proj, self.output_proj):
            nn.init.xavier_uniform_(lin.weight)
            nn.init.zeros_(lin.bias)


class MSDeformAttnLayer(nn.Module):
    """One deformable self-attention + FFN encoder layer (JAX
    ``MSDeformAttnLayer``)."""

    def __init__(self, d_model: int = 256, d_ffn: int = 1024, n_levels: int = 3,
                 n_heads: int = 8, n_points: int = 4, value_dtype: str = "float32",
                 island_dtype: str = "float32", impl: str = "exact"):
        super().__init__()
        if impl not in ("exact", "pallas_local"):
            raise ValueError(f"msdeform_impl must be exact or pallas_local, got {impl}")
        self.impl = impl
        self.value_dtype = dtype_of(value_dtype)
        self.island_dtype = dtype_of(island_dtype)
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, src: torch.Tensor, pos: torch.Tensor, reference_points: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """src (B, Len, C); pos (Len, C); reference_points (Len, L, 2)."""
        B, Len, C = src.shape
        sa = self.self_attn
        M, L, P = sa.n_heads, sa.n_levels, sa.n_points
        cdt = self.island_dtype
        q = (src + pos[None]).to(cdt)
        value = sa.value_proj(src.to(cdt)).reshape(B, Len, M, C // M).to(self.value_dtype)
        offsets = sa.sampling_offsets(q).reshape(B, Len, M, L, P, 2)
        attn = sa.attention_weights(q).reshape(B, Len, M, L * P).softmax(-1)
        attn = attn.reshape(B, Len, M, L, P)
        normalizer = torch.tensor(
            [[w, h] for (h, w) in spatial_shapes], dtype=torch.float32, device=src.device
        )
        locations = (
            reference_points[None, :, None, :, None, :]
            + offsets / normalizer[None, None, None, :, None, :]
        )
        out = ms_deform_attn(
            value.contiguous(), spatial_shapes, locations.float().contiguous(),
            attn.contiguous(),
            radius=LOCAL_RADIUS if self.impl == "pallas_local" else None,
        )  # (B, Len, C) in value_dtype; the queries are the level grids
        out = sa.output_proj(out.to(cdt))
        src = self.norm1(src.to(cdt) + out)
        ffn = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + ffn)


def reference_points(spatial_shapes: Sequence[Tuple[int, int]], device=None) -> torch.Tensor:
    """(Len, n_levels, 2) pixel-centre reference points (x, y), broadcast to
    every level (JAX ``_reference_points``: +0.5 centres, valid ratios 1)."""
    refs = []
    for Hl, Wl in spatial_shapes:
        ry = (torch.arange(Hl, dtype=torch.float32, device=device) + 0.5) / Hl
        rx = (torch.arange(Wl, dtype=torch.float32, device=device) + 0.5) / Wl
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
    ref = torch.cat(refs, dim=0)
    return ref[:, None, :].expand(ref.shape[0], len(spatial_shapes), 2)


class MSDeformAttnEncoder(nn.Module):
    def __init__(self, num_layers: int, **layer_kw):
        super().__init__()
        self.layers = nn.ModuleList(MSDeformAttnLayer(**layer_kw) for _ in range(num_layers))


class MSDeformAttnTransformer(nn.Module):
    """Holds the level embedding and the encoder, under the reference names
    ``transformer.level_embed`` / ``transformer.encoder.layers.{i}``."""

    def __init__(self, d_model: int, n_levels: int, num_layers: int, **layer_kw):
        super().__init__()
        self.level_embed = nn.Parameter(torch.randn(n_levels, d_model))
        self.encoder = MSDeformAttnEncoder(
            num_layers, d_model=d_model, n_levels=n_levels, **layer_kw
        )


class MSDeformAttnPixelDecoder(nn.Module):
    """Inputs: dict res2..res5 NCHW. Output: (mask_features (B, mask_dim,
    H/4, W/4) fp32, multi_scale [stride 32, 16, 8] NCHW in the input dtype)."""

    def __init__(self, in_channels: Dict[str, int], conv_dim: int = 256, mask_dim: int = 256,
                 num_enc_layers: int = 6, n_heads: int = 8, d_ffn: int = 1024,
                 n_points: int = 4,
                 transformer_in_features: Tuple[str, ...] = ("res3", "res4", "res5"),
                 value_dtype: str = "float32", island_dtype: str = "float32",
                 impl: str = "exact"):
        super().__init__()
        self.conv_dim = conv_dim
        self.levels = list(transformer_in_features)[::-1]  # res5, res4, res3
        self.island_dtype = dtype_of(island_dtype)
        self.input_proj = nn.ModuleList(
            nn.Sequential(
                Conv2d(in_channels[name], conv_dim, 1), GroupNorm(32, conv_dim, eps=1e-5)
            )
            for name in self.levels
        )
        self.transformer = MSDeformAttnTransformer(
            conv_dim, len(self.levels), num_enc_layers, d_ffn=d_ffn, n_heads=n_heads,
            n_points=n_points, value_dtype=value_dtype, island_dtype=island_dtype,
            impl=impl,
        )
        self.adapter_1 = Conv2d(
            in_channels["res2"], conv_dim, 1, bias=False, norm=GroupNorm(32, conv_dim, eps=1e-5)
        )
        self.layer_1 = Conv2d(
            conv_dim, conv_dim, 3, padding=1, bias=False, norm=GroupNorm(32, conv_dim, eps=1e-5)
        )
        self.mask_features = Conv2d(conv_dim, mask_dim, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        in_dtype = features["res2"].dtype
        cdt = self.island_dtype
        srcs, poss, shapes = [], [], []
        level_embed = self.transformer.level_embed
        for i, name in enumerate(self.levels):
            x = features[name].to(cdt)
            B, _, Hl, Wl = x.shape
            proj = self.input_proj[i](x)
            srcs.append(proj.flatten(2).transpose(1, 2))
            pe = position_embedding_sine_2d(Hl, Wl, self.conv_dim // 2, device=x.device)
            poss.append(pe.reshape(Hl * Wl, self.conv_dim) + level_embed[i][None])
            shapes.append((Hl, Wl))
        src = torch.cat(srcs, dim=1)
        pos = torch.cat(poss, dim=0)
        refs = reference_points(shapes, device=src.device)
        for layer in self.transformer.encoder.layers:
            src = layer(src, pos, refs, shapes)

        out_maps = []
        start = 0
        for Hl, Wl in shapes:
            out_maps.append(
                src[:, start : start + Hl * Wl].transpose(1, 2).reshape(B, self.conv_dim, Hl, Wl)
            )
            start += Hl * Wl

        # FPN fusion onto res2 (stride 4), in fp32 like the JAX convs whose
        # dtype is inferred from their fp32 params
        x2 = features["res2"].to(cdt).float()
        lateral = self.adapter_1(x2)
        top_up = F.interpolate(
            out_maps[-1], size=x2.shape[-2:], mode="bilinear", align_corners=False
        )
        y = F.relu(self.layer_1(lateral + top_up.float()))
        mask_features = self.mask_features(y)
        return mask_features, [m.to(in_dtype) for m in out_maps]
