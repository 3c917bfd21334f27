"""DINOv2 ViT-Adapter backbone, plain.

A frozen copy of the benchmarked package's ``models/backbones/vit_adapter.py``
(a ViT trunk on a stride-16 grid, the spatial prior, the extractors in the
ViT width, {res2..res5} out) with its attention computed densely (fp32 scores
and softmax) and the deformable sampling by the plain gather of
``deform.py``. Module and parameter names are the package's, so one state
dict loads into both.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.deform import MSDeformAttn, deform_attention, reference_points
from port_bench.reference.layers import (Conv2d, ConvTranspose2d, FrozenBatchNorm2d, LayerNorm, Linear,
                                         matmul)

LN_EPS = 1e-6


@functools.lru_cache(maxsize=64)
def bicubic_matrix(out_size: int, grid: int) -> np.ndarray:
    """(out_size, grid) interpolation matrix equal to ``F.interpolate(
    mode="bicubic", align_corners=False, scale_factor=(out + 0.1) / grid)``:
    DINOv2's position-embedding resampling, with its +0.1 fudge."""
    A = -0.75
    scale_factor = (out_size + 0.1) / grid

    def k1(x):  # |x| <= 1
        return ((A + 2.0) * x - (A + 3.0)) * x * x + 1.0

    def k2(x):  # 1 < |x| < 2
        return ((A * x - 5.0 * A) * x + 8.0 * A) * x - 4.0 * A

    M = np.zeros((out_size, grid), np.float64)
    for i in range(out_size):
        src = (i + 0.5) / scale_factor - 0.5
        f = math.floor(src)
        t = src - f
        for k, w in enumerate((k2(t + 1.0), k1(t), k1(1.0 - t), k2(2.0 - t))):
            g = min(max(f - 1 + k, 0), grid - 1)  # border replication
            M[i, g] += w
    return M.astype(np.float32)


def _resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear, ``align_corners=False``, not antialiased; NCHW."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def _tokens_to_map(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, h*w, C) -> (B, C, h, w)."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], h, w)


def _map_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) -> (B, h*w, C)."""
    return x.flatten(2).transpose(1, 2)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


def attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, L, H, Dh) in and out: fp32 scores and softmax, the weighted sum in v's dtype."""
    logits = matmul(q.float().permute(0, 2, 1, 3), k.float().permute(0, 2, 3, 1))
    w = (logits / math.sqrt(q.shape[-1])).softmax(dim=-1).to(v.dtype)
    return matmul(w, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3).contiguous()


class Attention(nn.Module):
    """Unmasked multi-head self-attention with a fused qkv projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        H = self.num_heads
        q, k, v = (t.unflatten(-1, (H, C // H)) for t in self.qkv(x).split(C, dim=-1))
        return self.proj(attention_dense(q, k, v).reshape(B, L, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, C, ceil(H/ps), ceil(W/ps)); a size the patch
        does not divide is zero-padded on both sides (Flax ``SAME``)."""
        ps = self.patch_size
        ph, pw = (-x.shape[-2]) % ps, (-x.shape[-1]) % ps
        if ph or pw:
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return self.proj(x)


class DinoViT(nn.Module):
    """DINOv2-style ViT trunk on a stride-16 grid."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 patch_size: int = 16, pretrain_grid: int = 37):
        super().__init__()
        self.pretrain_grid = pretrain_grid
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pretrain_grid * pretrain_grid + 1, embed_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads) for _ in range(depth)
        )

    def prepare_tokens(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
        """(B, 3, H, W) -> (patch tokens (B, Hp*Wp, C), cls (B, 1, C), Hp, Wp)."""
        y = self.patch_embed(x)
        B, C, Hp, Wp = y.shape
        tokens = _map_to_tokens(y)
        G = self.pretrain_grid
        pe = self.pos_embed[0, 1:].reshape(G, G, C).float()
        if (Hp, Wp) != (G, G):
            Mh = torch.from_numpy(bicubic_matrix(Hp, G)).to(pe.device)
            Mw = torch.from_numpy(bicubic_matrix(Wp, G)).to(pe.device)
            pe = torch.einsum("hg,gvc->hvc", Mh, pe)
            pe = torch.einsum("wv,hvc->hwc", Mw, pe)
        tokens = tokens + pe.reshape(1, Hp * Wp, C).to(tokens.dtype)
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(B, 1, C).to(tokens.dtype)
        return tokens, cls, Hp, Wp

    def run_blocks(self, x: torch.Tensor, cls: torch.Tensor, start: int, end: int):
        y = torch.cat([cls, x], dim=1)
        for blk in self.blocks[start:end]:
            y = blk(y)
        return y[:, 1:], y[:, :1]


class SpatialPriorModule(nn.Module):
    """Conv stem -> c1..c4 at strides 4/8/16/32, projected to the ViT width."""

    def __init__(self, inplanes: int = 64, embed_dim: int = 1024):
        super().__init__()

        def conv_bn_relu(cin, cout, stride):
            return [Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False),
                    FrozenBatchNorm2d(cout), nn.ReLU()]

        self.stem = nn.Sequential(
            *conv_bn_relu(3, inplanes, 2), *conv_bn_relu(inplanes, inplanes, 1),
            *conv_bn_relu(inplanes, inplanes, 1), nn.MaxPool2d(3, stride=2, padding=1),
        )
        self.conv2 = nn.Sequential(*conv_bn_relu(inplanes, 2 * inplanes, 2))
        self.conv3 = nn.Sequential(*conv_bn_relu(2 * inplanes, 4 * inplanes, 2))
        self.conv4 = nn.Sequential(*conv_bn_relu(4 * inplanes, 4 * inplanes, 2))
        self.fc1 = Conv2d(inplanes, embed_dim, 1)
        self.fc2 = Conv2d(2 * inplanes, embed_dim, 1)
        self.fc3 = Conv2d(4 * inplanes, embed_dim, 1)
        self.fc4 = Conv2d(4 * inplanes, embed_dim, 1)

    def forward(self, x: torch.Tensor):
        c1 = self.stem(x)
        c2 = self.conv2(c1)
        c3 = self.conv3(c2)
        c4 = self.conv4(c3)
        return self.fc1(c1), self.fc2(c2), self.fc3(c3), self.fc4(c4)


class DWConv(nn.Module):
    """One depthwise 3x3 applied to each level grid of the token sequence."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor, shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        parts, start = [], 0
        for h, w in shapes:
            seg = _tokens_to_map(x[:, start : start + h * w], h, w)
            parts.append(_map_to_tokens(self.dwconv(seg)))
            start += h * w
        return torch.cat(parts, dim=1)


class ConvFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor, shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), shapes), approximate="none"))


class Extractor(nn.Module):
    """Spatial tokens (query) attend into the ViT token grid, then a ConvFFN."""

    def __init__(self, dim: int, num_heads: int, n_points: int = 4, with_cffn: bool = True,
                 cffn_ratio: float = 0.25):
        super().__init__()
        self.query_norm = LayerNorm(dim, eps=LN_EPS)
        self.feat_norm = LayerNorm(dim, eps=LN_EPS)
        self.attn = MSDeformAttn(dim, n_levels=1, n_heads=num_heads, n_points=n_points)
        if with_cffn:
            self.ffn_norm = LayerNorm(dim, eps=LN_EPS)
            self.ffn = ConvFFN(dim, int(dim * cffn_ratio))
        else:
            self.ffn = None

    def forward(self, query, refs, feat, feat_shape, shapes):
        query = query + deform_attention(self.attn, self.query_norm(query), refs,
                                         self.feat_norm(feat), [feat_shape])
        if self.ffn is not None:
            query = query + self.ffn(self.ffn_norm(query), shapes)
        return query


class InteractionBlock(nn.Module):
    """An extractor after a span of trunk blocks (run by the caller), and on the
    last interaction the extra extractors."""

    def __init__(self, n_extra: int, dim: int, num_heads: int, n_points: int, **extractor_kw):
        super().__init__()
        self.extractor = Extractor(dim, num_heads, n_points, **extractor_kw)
        if n_extra:
            self.extra_extractors = nn.ModuleList(
                Extractor(dim, num_heads, n_points, **extractor_kw) for _ in range(n_extra))


class ViTAdapter(nn.Module):
    """DINOv2 ViT + adapter -> {res2..res5} in ViT width."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 patch_size: int = 16, conv_inplane: int = 64, deform_num_heads: int = 16,
                 n_points: int = 4,
                 interaction_indexes: Sequence[Tuple[int, int]] = ((0, 5), (6, 11), (12, 17), (18, 23)),
                 with_cffn: bool = True, cffn_ratio: float = 0.25, add_vit_feature: bool = True,
                 pretrain_grid: int = 37,
                 out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")):
        super().__init__()
        self.embed_dim = embed_dim
        self.interaction_indexes = tuple(tuple(se) for se in interaction_indexes)
        self.add_vit_feature = add_vit_feature
        self.out_features = tuple(out_features)
        self.vit_module = DinoViT(embed_dim, depth, num_heads, patch_size,
                                  pretrain_grid=pretrain_grid)
        self.spm = SpatialPriorModule(conv_inplane, embed_dim)
        self.level_embed = nn.Parameter(torch.zeros(3, embed_dim))
        n = len(self.interaction_indexes)
        self.interactions = nn.ModuleList(
            InteractionBlock(2 if i == n - 1 else 0, embed_dim, deform_num_heads, n_points,
                             with_cffn=with_cffn, cffn_ratio=cffn_ratio)
            for i in range(n)
        )
        self.up = ConvTranspose2d(embed_dim, embed_dim, 2, stride=2)
        for i in (1, 2, 3, 4):
            self.add_module(f"norm{i}", FrozenBatchNorm2d(embed_dim))
        self.out_channels: Dict[str, int] = {name: embed_dim for name in self.out_features}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, 3, H, W) -> {res2..res5}."""
        vit = self.vit_module
        tokens, cls, Hp, Wp = vit.prepare_tokens(x)
        c1, c2, c3, c4 = self.spm(x)
        # align the prior's grids to the ViT grid
        shapes = ((2 * Hp, 2 * Wp), (Hp, Wp), (Hp // 2, Wp // 2))
        le = self.level_embed.to(c2.dtype)
        c = torch.cat(
            [_map_to_tokens(_resize(m, s)) + le[i] for i, (m, s) in enumerate(zip((c2, c3, c4), shapes))],
            dim=1,
        )
        refs_c1 = reference_points(shapes, device=x.device)[:, 1:2]  # into the one ViT level

        outs: List[torch.Tensor] = []
        for (s, e), inter in zip(self.interaction_indexes, self.interactions):
            tokens, cls = vit.run_blocks(tokens, cls, s, e + 1)
            c = inter.extractor(c, refs_c1, tokens, (Hp, Wp), shapes)
            for extra in getattr(inter, "extra_extractors", ()):
                c = extra(c, refs_c1, tokens, (Hp, Wp), shapes)
            outs.append(_tokens_to_map(tokens, Hp, Wp))

        n2, n3 = shapes[0][0] * shapes[0][1], shapes[1][0] * shapes[1][1]
        c2o = _tokens_to_map(c[:, :n2], *shapes[0])
        c3o = _tokens_to_map(c[:, n2 : n2 + n3], *shapes[1])
        c4o = _tokens_to_map(c[:, n2 + n3 :], *shapes[2])
        c1o = self.up(c2o)
        if c1.shape[-2:] != c1o.shape[-2:]:  # only when 32 does not divide H, W
            c1 = F.interpolate(c1, size=c1o.shape[-2:], mode="bilinear", align_corners=False,
                               antialias=True)
        c1o = c1o + c1

        if self.add_vit_feature:
            x1, x2, x3, x4 = (outs + [outs[-1]] * 4)[:4]
            c1o = c1o + _resize(x1, c1o.shape[-2:])
            c2o = c2o + _resize(x2, shapes[0])
            c3o = c3o + x3
            c4o = c4o + _resize(x4, shapes[2])

        f = {"res2": self.norm1(c1o), "res3": self.norm2(c2o),
             "res4": self.norm3(c3o), "res5": self.norm4(c4o)}
        return {k: v.contiguous() for k, v in f.items() if k in self.out_features}


def build_vit_adapter(cfg) -> ViTAdapter:
    """cfg: a backbone config (its ``vit_*`` fields); the trunk runs on a
    stride-16 grid whatever ``vit_patch_size`` says."""
    return ViTAdapter(
        embed_dim=cfg.vit_embed_dim, depth=cfg.vit_depth, num_heads=cfg.vit_num_heads,
        patch_size=16, conv_inplane=cfg.vit_conv_inplane,
        deform_num_heads=cfg.vit_deform_num_heads, n_points=cfg.vit_n_points,
        interaction_indexes=cfg.vit_interaction_indexes, with_cffn=cfg.vit_with_cffn,
        out_features=tuple(cfg.out_features))
