"""Swin Transformer backbone (shifted windows, relative position bias, patch
merging, per-stage output norms feeding {res2..res5}).

Counterpart: ``dvis_plus_tpu/models/backbones/swin.py`` (``_rel_pos_index``
:25, ``_QKV`` :34, ``WindowAttention`` :70, ``_window_partition`` /
``_window_reverse`` :149-158, ``_shift_mask`` :161, ``SwinBlock`` :174,
``PatchMerging`` :240, ``SwinTransformer`` :257, ``build_swin`` :324).
Module, parameter and buffer names follow the reference checkpoints
(``patch_embed.proj``, ``layers.{s}.blocks.{b}.attn.qkv``,
``attn.relative_position_bias_table``, ``attn.relative_position_index``,
``layers.{s}.downsample.{norm,reduction}``, ``norm{s}``), so a zoo ``.pth``
loads with no missing or unexpected backbone key.

Input (B, 3, H, W) NCHW, output {res2..res5} NCHW; the blocks work NHWC as
the JAX module does. Every layer computes in its input's dtype (the caller
casts the images to ``model.compute_dtype``); window attention keeps fp32
scores and softmax, or, with ``backbone.swin_fast_softmax`` and bf16 inputs,
the JAX module's bf16 scores (:111-126;
``ops/swin_window_attn.py::window_attention_fast_softmax_torch``). In eval
mode it runs kernel B2 on CUDA (``ops/swin_window_attn.py``) for both values
of ``backbone.swin_fused_attn`` and of ``backbone.swin_fast_softmax`` (the
JAX module's fused kernel takes precedence over the bf16 scores where it
runs, :97-106); in training mode (the module's ``training``
flag, which the trainer sets) it runs the plain op, which autograd
differentiates, as the JAX package trains with ``swin_fused_attn`` off.

Training mode also drops residual branches (stochastic depth): block i of
n keeps its attention and MLP branches each with probability
1 - ``drop_path_rate`` * i / (n - 1) a sample, and scales a kept branch by
1 / keep (the JAX ``SwinBlock._drop_path`` :231-237). The coins come from
the step's draws (``utils/draws.py``) at the sites
``("drop_path", i, "attn" | "mlp")``. The JAX ``Segmenter`` never passes
``training`` to its backbone (``models/segmenter/segmenter.py:84``), so the
JAX package trains Swin without it; the reference, and the port, drop.

Semantics kept from the JAX module (and the reference):
- the window size is fixed for every map size: a small map is padded up to
  one window, and the cyclic shift stays on even then;
- windows pad after ``norm1`` with zeros, and the padded tokens take part in
  attention;
- the shift mask is -100 (not -inf) in window-partition order; window i
  uses mask row i % nW;
- GELU is exact; all LayerNorm eps are 1e-5; the patch embed pads H and W up
  to a multiple of the patch size.
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dvis_plus_tpu_torch.models.layers import Conv2d, LayerNorm, Linear
from dvis_plus_tpu_torch.ops.swin_window_attn import (
    window_attention,
    window_attention_fast_softmax_torch,
    window_attention_torch,
)

SWIN_VARIANTS = {
    "swin_t": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "swin_s": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "swin_b": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "swin_l": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
}


def rel_pos_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) relative position index into the bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0) + ws - 1
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws*ws, C), windows batch-major."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(wins: torch.Tensor, ws: int, B: int, H: int, W: int) -> torch.Tensor:
    C = wins.shape[-1]
    x = wins.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


@functools.lru_cache(maxsize=64)
def shift_mask(H: int, W: int, ws: int, shift: int, device: torch.device) -> torch.Tensor:
    """(nW, N, N) float32 additive mask of the shifted windows of an (H, W)
    padded map (the reference's img_mask regions), cached per device."""
    img = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    wins = window_partition(torch.from_numpy(img), ws).reshape(-1, ws * ws)
    diff = wins[:, None, :] - wins[:, :, None]
    mask = torch.where(diff != 0, -100.0, 0.0).to(torch.float32)
    return mask.to(device)


class WindowAttention(nn.Module):
    """In training mode the plain op (autograd through it), in eval kernel
    B2 on CUDA tensors. ``fast_softmax`` (``backbone.swin_fast_softmax``):
    the plain op keeps bf16 scores for bf16 inputs; B2 serves it on the card
    all the same, the JAX precedence of the fused kernel (``swin.py:97-106``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True,
                 fast_softmax: bool = False):
        super().__init__()
        self.dim, self.num_heads, self.window_size = dim, num_heads, window_size
        self.fast_softmax = fast_softmax
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads)
        )
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer(
            "relative_position_index", torch.from_numpy(rel_pos_index(window_size)).long()
        )
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x (B_, N, C) windows; mask (nW, N, N) float32 or None."""
        N, C, H = x.shape[1], self.dim, self.num_heads
        q, k, v = self.qkv(x).split(C, dim=-1)  # strided views, heads on columns
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        bias = bias.reshape(N, N, H).permute(2, 0, 1).float().contiguous()  # (H, N, N)
        if self.training:
            plain = window_attention_fast_softmax_torch if self.fast_softmax else window_attention_torch
            return self.proj(plain(q, k, v, bias, mask, H))
        kw = {"fast_softmax": True} if self.fast_softmax else {}
        return self.proj(window_attention(q, k, v, bias, mask, H, **kw))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


def drop_path(x: torch.Tensor, rate: float, draws, site) -> torch.Tensor:
    """Each sample of ``x`` (batch first) kept with probability 1 - ``rate``
    (a uniform coin from ``draws`` at ``site`` below it) and scaled by
    1 / keep, or zeroed."""
    keep = 1.0 - rate
    coins = draws.uniform(site, (x.shape[0],)).to(x.device)
    mask = (coins < keep).to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))
    return x * mask / keep


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, drop_path: float = 0.0,
                 index: int = 0, fast_softmax: bool = False):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.drop_path, self.index = drop_path, index
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size, qkv_bias, fast_softmax)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _branch(self, y: torch.Tensor, draws, which: str) -> torch.Tensor:
        if not self.training or self.drop_path == 0.0:
            return y
        if draws is None:
            raise ValueError("a Swin block in training mode drops paths: pass the step's draws")
        return drop_path(y, self.drop_path, draws, ("drop_path", self.index, which))

    def forward(self, x: torch.Tensor, draws=None) -> torch.Tensor:
        """x (B, H, W, C); ``draws``: the step's, in training mode."""
        B, H, W, C = x.shape
        ws, shift = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x)
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = shift_mask(Hp, Wp, ws, shift, x.device)
        wins = self.attn(window_partition(x, ws), mask)
        x = window_reverse(wins, ws, B, Hp, Wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + self._branch(x[:, :H, :W], draws, "attn")
        return x + self._branch(self.mlp(self.norm2(x)), draws, "mlp")


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
        )
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """One stage: ``blocks`` then an optional ``downsample``."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, downsample: bool, drop_paths: Sequence[float] = (),
                 first: int = 0, fast_softmax: bool = False):
        """``drop_paths``: the blocks' rates; ``first``: the first block's
        index in the whole trunk."""
        super().__init__()
        rates = list(drop_paths) or [0.0] * depth
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, 0 if b % 2 == 0 else window_size // 2,
                      mlp_ratio, qkv_bias, drop_path=rates[b], index=first + b,
                      fast_softmax=fast_softmax)
            for b in range(depth)
        )
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, H/ps, W/ps, C)."""
        ps = self.patch_size
        H, W = x.shape[-2:]
        x = F.pad(x, (0, (ps - W % ps) % ps, 0, (ps - H % ps) % ps))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class SwinTransformer(nn.Module):
    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, patch_size: int = 4,
                 out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5"),
                 drop_path_rate: float = 0.0, fast_softmax: bool = False):
        super().__init__()
        self.out_features = tuple(out_features)
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        n = len(depths)
        rates = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        starts = np.cumsum([0, *depths])
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2**s, depths[s], num_heads[s], window_size, mlp_ratio,
                       qkv_bias, downsample=s < n - 1, drop_paths=rates[starts[s]:starts[s + 1]],
                       first=int(starts[s]), fast_softmax=fast_softmax)
            for s in range(n)
        )
        self.out_channels: Dict[str, int] = {}
        for s in range(n):
            name = f"res{s + 2}"
            if name in self.out_features:
                self.add_module(f"norm{s}", LayerNorm(embed_dim * 2**s, eps=1e-5))
                self.out_channels[name] = embed_dim * 2**s

    def forward(self, x: torch.Tensor, draws=None) -> Dict[str, torch.Tensor]:
        """``draws``: the training step's (stochastic depth in training mode)."""
        x = self.patch_embed(x)
        outs = {}
        for s, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x, draws)
            name = f"res{s + 2}"
            if name in self.out_features:
                outs[name] = getattr(self, f"norm{s}")(x).permute(0, 3, 1, 2).contiguous()
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs


def build_swin(cfg) -> SwinTransformer:
    """cfg: a backbone config. The named variants fix their widths; another
    ``swin_*`` name reads ``swin_embed_dim`` / ``swin_depths`` /
    ``swin_num_heads``."""
    kw = dict(SWIN_VARIANTS[cfg.name]) if cfg.name in SWIN_VARIANTS else dict(
        embed_dim=cfg.swin_embed_dim,
        depths=tuple(cfg.swin_depths),
        num_heads=tuple(cfg.swin_num_heads),
    )
    return SwinTransformer(
        window_size=cfg.swin_window_size,
        mlp_ratio=cfg.swin_mlp_ratio,
        qkv_bias=cfg.swin_qkv_bias,
        patch_size=cfg.swin_patch_size,
        out_features=tuple(cfg.out_features),
        drop_path_rate=cfg.swin_drop_path_rate,
        fast_softmax=cfg.swin_fast_softmax,
        **kw,
    )
