"""ViT-Adapter (DINOv2) backbone: a ViT trunk on a stride-16 grid plus the
spatial adapter that turns its tokens into {res2..res5}, all in ViT width.

Counterpart: ``dvis_plus_tpu/models/backbones/vit_adapter.py``
(``_torch_bicubic_matrix`` :36, ``LayerScale`` :69, ``ViTBlock`` :79,
``DinoViT`` :102, ``SpatialPriorModule`` :165, ``DeformAttnModule`` :191,
``ConvFFN`` :237, ``Extractor`` :266, ``Injector`` :322, ``ViTAdapter`` :343,
``build_vit_adapter`` :460). Module and parameter names follow the reference
checkpoints (``vit_module.{cls_token,pos_embed,patch_embed.proj}``,
``vit_module.blocks.{n}.{norm1,attn.qkv,attn.proj,ls1.gamma,norm2,mlp.fc1,
mlp.fc2,ls2.gamma}``, ``spm.{stem.0..7,conv2,conv3,conv4,fc1..fc4}``,
``interactions.{i}.extractor.*``, ``interactions.{last}.extra_extractors.{j}.*``,
optional ``interactions.{i}.injector.*``, ``up``, ``norm1..4``,
``level_embed``), so a zoo ``.pth`` loads with no backbone key left over.

Input (B, 3, H, W) NCHW, output {res2..res5} NCHW; token sequences are
(B, L, C). Every layer computes in its input's dtype (the caller casts the
images to ``model.compute_dtype``).

Semantics kept from the JAX module (and the reference):
- every LayerNorm has eps 1e-6 (trunk and adapter); GELU is exact;
- the trunk's attention holds one fused ``qkv`` projection, so q, k and v
  reach the attention as strided column views of its output and nothing is
  copied; ``attn_impl="flash"`` routes them through kernel B3
  (``ops/flash_attn.py``), ``"dense"`` through its plain version (fp32 scores
  and softmax);
- the position embedding is resampled from the pretraining grid with
  torch's bicubic kernel (A = -0.75), the reference's +0.1 scale fudge and
  border replication, as two host-built matrices;
- the cls token rides through the blocks in front of the patch tokens and
  never reaches the extractors;
- the deformable attentions run kernel B1 (``ops/msdeform.py``, exact
  form). As in the port's pixel decoder, the attention weights take their
  softmax in the query's dtype and reach the kernel in that dtype (it reads
  bfloat16 weights as float32, as its plain version does); the locations are
  float32; the value keeps the query's dtype and so does the result.
  ``deform_ratio`` changes no shape (``value_proj`` is C -> C);
- one depthwise conv is shared by the three level grids of a ConvFFN;
- every resize is bilinear, ``align_corners=False``, not antialiased, the
  0.5x downsample of the last trunk output included. Only the stride-4 prior
  added to ``up``'s output keeps the JAX module's antialiased resize, which
  is the identity whenever H and W divide by 32
  (``model.size_divisibility``).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dvis_plus_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    FrozenBatchNorm2d,
    LayerNorm,
    Linear,
)
from dvis_plus_tpu_torch.models.segmenter.pixel_decoder import MSDeformAttn, reference_points
from dvis_plus_tpu_torch.ops.flash_attn import attention_torch, flash_self_attention
from dvis_plus_tpu_torch.ops.msdeform import ms_deform_attn

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


class Attention(nn.Module):
    """Unmasked multi-head self-attention with a fused qkv projection."""

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "dense"):
        super().__init__()
        if attn_impl not in ("dense", "flash"):
            raise ValueError(f"attn_impl must be dense or flash, got {attn_impl!r}")
        self.num_heads, self.attn_impl = num_heads, attn_impl
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        H = self.num_heads
        # strided views of one (B, L, 3C) tensor, heads on columns
        q, k, v = (t.unflatten(-1, (H, C // H)) for t in self.qkv(x).split(C, dim=-1))
        attend = flash_self_attention if self.attn_impl == "flash" else attention_torch
        return self.proj(attend(q, k, v).reshape(B, L, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 attn_impl: str = "dense"):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, attn_impl)
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
                 patch_size: int = 16, pretrain_grid: int = 37, attn_impl: str = "dense"):
        super().__init__()
        self.pretrain_grid = pretrain_grid
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.randn(1, pretrain_grid * pretrain_grid + 1, embed_dim) * 0.02
        )
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, attn_impl=attn_impl) for _ in range(depth)
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


def deform_attention(sa: MSDeformAttn, query: torch.Tensor, refs: torch.Tensor,
                     feat: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]]):
    """Deformable cross-attention of the adapter (JAX ``DeformAttnModule``):
    query (B, Lq, C), refs (Lq, L, 2), feat (B, Len, C) over ``spatial_shapes``.
    The attention weights go to the kernel in the query's dtype and the
    result comes back in the value's."""
    B, Lq, C = query.shape
    M, L, P = sa.n_heads, sa.n_levels, sa.n_points
    value = sa.value_proj(feat).reshape(B, feat.shape[1], M, C // M)
    offsets = sa.sampling_offsets(query).reshape(B, Lq, M, L, P, 2)
    attn = sa.attention_weights(query).reshape(B, Lq, M, L * P).softmax(-1)
    normalizer = torch.tensor(
        [[w, h] for (h, w) in spatial_shapes], dtype=torch.float32, device=query.device
    )
    locations = (
        refs[None, :, None, :, None, :] + offsets / normalizer[None, None, None, :, None, :]
    )
    out = ms_deform_attn(
        value.contiguous(), spatial_shapes, locations.float().contiguous(),
        attn.reshape(B, Lq, M, L, P).contiguous(),
    )  # (B, Lq, C) in value's dtype
    return sa.output_proj(out)


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
    """Spatial tokens (query) attend into the ViT token grid, then a ConvFFN.
    ``coarse_s8`` (serving, ``backbone.vit_extractor_coarse``): the stride-8
    level's attention residual is computed on 2x2-mean-pooled queries with
    coarse-grid reference points and upsampled bilinearly before the add."""

    def __init__(self, dim: int, num_heads: int, n_points: int = 4, with_cffn: bool = True,
                 cffn_ratio: float = 0.25, coarse_s8: bool = False):
        super().__init__()
        self.coarse_s8 = coarse_s8
        self.query_norm = LayerNorm(dim, eps=LN_EPS)
        self.feat_norm = LayerNorm(dim, eps=LN_EPS)
        self.attn = MSDeformAttn(dim, n_levels=1, n_heads=num_heads, n_points=n_points)
        if with_cffn:
            self.ffn_norm = LayerNorm(dim, eps=LN_EPS)
            self.ffn = ConvFFN(dim, int(dim * cffn_ratio))
        else:
            self.ffn = None

    def forward(self, query: torch.Tensor, refs: torch.Tensor, feat: torch.Tensor,
                feat_shape: Tuple[int, int], shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        qn, fn = self.query_norm(query), self.feat_norm(feat)
        if not self.coarse_s8:
            attn = deform_attention(self.attn, qn, refs, fn, [feat_shape])
        else:
            B, _, C = query.shape
            h2, w2 = shapes[0]
            n2, hc, wc = h2 * w2, h2 // 2, w2 // 2
            q2 = qn[:, :n2].reshape(B, hc, 2, wc, 2, C).mean(dim=(2, 4))
            q_coarse = torch.cat([q2.reshape(B, hc * wc, C), qn[:, n2:]], dim=1)
            refs_coarse = torch.cat(
                [reference_points([(hc, wc)], device=refs.device), refs[n2:]], dim=0
            )
            attn_c = deform_attention(self.attn, q_coarse, refs_coarse, fn, [feat_shape])
            a2 = _resize(_tokens_to_map(attn_c[:, : hc * wc], hc, wc), (h2, w2))
            attn = torch.cat([_map_to_tokens(a2), attn_c[:, hc * wc :]], dim=1)
        query = query + attn
        if self.ffn is not None:
            query = query + self.ffn(self.ffn_norm(query), shapes)
        return query


class Injector(nn.Module):
    """ViT tokens (query) attend into the three spatial levels."""

    def __init__(self, dim: int, num_heads: int, n_points: int = 4, n_levels: int = 3):
        super().__init__()
        self.query_norm = LayerNorm(dim, eps=LN_EPS)
        self.feat_norm = LayerNorm(dim, eps=LN_EPS)
        self.attn = MSDeformAttn(dim, n_levels=n_levels, n_heads=num_heads, n_points=n_points)
        self.gamma = nn.Parameter(torch.zeros(dim))

    def forward(self, query: torch.Tensor, refs: torch.Tensor, feat: torch.Tensor,
                shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        attn = deform_attention(
            self.attn, self.query_norm(query), refs, self.feat_norm(feat), shapes
        )
        return query + self.gamma.to(query.dtype) * attn


class InteractionBlock(nn.Module):
    """One interaction: an optional injector, a span of trunk blocks (run by
    the caller, which owns the trunk), an extractor, and on the last
    interaction the extra extractors."""

    def __init__(self, use_injector: bool, n_extra: int, dim: int, num_heads: int,
                 n_points: int, **extractor_kw):
        super().__init__()
        if use_injector:
            self.injector = Injector(dim, num_heads, n_points)
        self.extractor = Extractor(dim, num_heads, n_points, **extractor_kw)
        if n_extra:
            self.extra_extractors = nn.ModuleList(
                Extractor(dim, num_heads, n_points, **extractor_kw) for _ in range(n_extra)
            )


class ViTAdapter(nn.Module):
    """DINOv2 ViT + adapter -> {res2..res5} in ViT width."""

    def __init__(self, embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 patch_size: int = 16, conv_inplane: int = 64, deform_num_heads: int = 16,
                 n_points: int = 4,
                 interaction_indexes: Sequence[Tuple[int, int]] = ((0, 5), (6, 11), (12, 17), (18, 23)),
                 with_cffn: bool = True, cffn_ratio: float = 0.25, deform_ratio: float = 0.5,
                 add_vit_feature: bool = True, use_injector: bool = False,
                 extractor_coarse_s8: bool = False, pretrain_grid: int = 37,
                 attn_impl: str = "dense",
                 out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")):
        super().__init__()
        del deform_ratio  # no shape depends on it: value_proj is C -> C
        self.embed_dim = embed_dim
        self.interaction_indexes = tuple(tuple(se) for se in interaction_indexes)
        self.add_vit_feature, self.use_injector = add_vit_feature, use_injector
        self.out_features = tuple(out_features)
        self.vit_module = DinoViT(embed_dim, depth, num_heads, patch_size,
                                  pretrain_grid=pretrain_grid, attn_impl=attn_impl)
        self.spm = SpatialPriorModule(conv_inplane, embed_dim)
        self.level_embed = nn.Parameter(torch.randn(3, embed_dim))
        n = len(self.interaction_indexes)
        self.interactions = nn.ModuleList(
            InteractionBlock(use_injector, 2 if i == n - 1 else 0, embed_dim, deform_num_heads,
                             n_points, with_cffn=with_cffn, cffn_ratio=cffn_ratio,
                             coarse_s8=extractor_coarse_s8)
            for i in range(n)
        )
        self.up = ConvTranspose2d(embed_dim, embed_dim, 2, stride=2)
        for i in (1, 2, 3, 4):
            self.add_module(f"norm{i}", FrozenBatchNorm2d(embed_dim))
        self.out_channels: Dict[str, int] = {name: embed_dim for name in self.out_features}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
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
        refs_x = reference_points([(Hp, Wp)], device=x.device).expand(Hp * Wp, 3, 2)

        outs: List[torch.Tensor] = []
        for (s, e), inter in zip(self.interaction_indexes, self.interactions):
            if self.use_injector:
                tokens = inter.injector(tokens, refs_x, c, shapes)
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
    """cfg: a backbone config (its ``vit_*`` fields). The trunk runs on a
    stride-16 grid whatever ``vit_patch_size`` says (DINOv2's patch-14
    weights are resampled to 16 when a checkpoint is converted)."""
    return ViTAdapter(
        embed_dim=cfg.vit_embed_dim,
        depth=cfg.vit_depth,
        num_heads=cfg.vit_num_heads,
        patch_size=16,
        conv_inplane=cfg.vit_conv_inplane,
        deform_num_heads=cfg.vit_deform_num_heads,
        n_points=cfg.vit_n_points,
        interaction_indexes=cfg.vit_interaction_indexes,
        with_cffn=cfg.vit_with_cffn,
        deform_ratio=cfg.vit_deform_ratio,
        attn_impl="flash" if cfg.vit_flash_attention else "dense",
        extractor_coarse_s8=cfg.vit_extractor_coarse,
        out_features=tuple(cfg.out_features),
    )
