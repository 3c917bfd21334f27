"""The frozen CLIP trunks of the open-vocabulary models and the CLIP text
tower.

Counterpart: ``dvis_plus_tpu/models/ov/clip_backbone.py`` (``ConvNeXtBlock``
:30, ``ConvNeXt`` :49, ``CLIPVisualHead`` :72, ``_FrozenBN`` :90,
``CLIPBottleneck`` :110, ``ModifiedResNet`` :142, ``CLIPAttentionPool``
:179, ``CLIPTextEncoder`` :235, ``CLIPBackbone`` :279). Parameters carry
open_clip's names under ``clip_model.`` (the reference checkpoints'
``backbone.clip_model.*``, the names ``core/zoo_convert.py``
reads: ``visual.trunk.stem.{0,1}``, ``visual.trunk.stages.{s}.downsample.{0,1}``,
``visual.trunk.stages.{s}.blocks.{b}.{conv_dw,norm,mlp.fc1,mlp.fc2,gamma}``,
``visual.trunk.head.norm``, ``visual.head.mlp.{fc1,fc2}``; for RN50
``visual.{conv,bn}{1,2,3}``, ``visual.layer{L}.{b}.{conv,bn}{1,2,3}``,
``visual.layer{L}.{b}.downsample.{0,1}``, ``visual.attnpool.*``; and
``logit_scale``). The text tower takes open_clip's text names
(``token_embedding``, ``transformer.resblocks.{i}``, ``ln_final``,
``text_projection``), so :func:`text_state_dict` loads an open_clip
checkpoint as it is.

Feature maps are NCHW. Every layer computes in its input's dtype (the
caller casts the images to ``model.compute_dtype``); layer norms reduce in
fp32. The text tower's layers have no ``dtype`` in the JAX module, so it
computes in fp32. The RN50 attention pool is the masked form of the
reference: keys are the dense tokens plus the positional table resized to
the map, one query per mask (the mean token plus the table's first row),
keys outside the mask get -1e9, an empty mask attends everywhere.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dvis_plus_tpu_torch.models.layers import Conv2d, FrozenBatchNorm2d, LayerNorm, Linear
from dvis_plus_tpu_torch.models.ov.heads import resize_masks
from dvis_plus_tpu_torch.models.segmenter.transformer_decoder import MultiheadAttention

_NEG_INF = -1e9


class LayerNorm2d(LayerNorm):
    """LayerNorm over the channels of an NCHW map (timm's ``LayerNorm2d``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ConvNeXtBlock(nn.Module):
    """Depthwise 7x7, LayerNorm (eps 1e-6), MLP with exact GELU, layer scale."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6):
        super().__init__()
        self.conv_dw = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, 4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mlp(self.norm(self.conv_dw(x).permute(0, 2, 3, 1)))
        return x + (y * self.gamma.to(y.dtype)).permute(0, 3, 1, 2)


class _Stage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, first: bool):
        super().__init__()
        self.downsample = (nn.Identity() if first else
                           nn.Sequential(LayerNorm2d(in_dim, eps=1e-6), Conv2d(in_dim, dim, 2, stride=2)))
        self.blocks = nn.Sequential(*(ConvNeXtBlock(dim) for _ in range(depth)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.downsample(x))


class _TrunkHead(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-6)


class ConvNeXt(nn.Module):
    """ConvNeXt trunk (timm names): {res2..res5} and ``clip_vis_dense`` =
    res5. ``head.norm`` is applied by :meth:`CLIPBackbone.pool_clip`
    to the mask-pooled features, not here."""

    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (192, 384, 768, 1536)):
        super().__init__()
        self.stem = nn.Sequential(Conv2d(3, dims[0], 4, stride=4), LayerNorm2d(dims[0], eps=1e-6))
        self.stages = nn.ModuleList(
            _Stage(dims[max(s - 1, 0)], dims[s], depths[s], s == 0) for s in range(len(depths))
        )
        self.head = _TrunkHead(dims[-1])

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outs = {}
        y = self.stem(x)
        for s, stage in enumerate(self.stages):
            y = stage(y)
            outs[f"res{s + 2}"] = y
        outs["clip_vis_dense"] = y
        return outs


class _ConvNeXtVisual(nn.Module):
    def __init__(self, depths, dims, embed_dim: int):
        super().__init__()
        self.trunk = ConvNeXt(depths, dims)
        self.head = nn.Module()
        # open_clip convnext_*_d projection: fc1 -> GELU -> fc2 (JAX
        # CLIPVisualHead: hidden width = the trunk's last width)
        self.head.mlp = _Mlp(dims[-1], dims[-1], embed_dim)


class CLIPBottleneck(nn.Module):
    """CLIP's anti-aliased bottleneck (expansion 4): every conv has stride 1;
    the stride is an average pool after conv2, and before the shortcut's 1x1
    conv (``downsample.0``, its BN ``downsample.1``)."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * 4
        self.stride = stride
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out)
        self.downsample = None
        if stride > 1 or in_ch != out:
            self.downsample = nn.ModuleDict({"0": Conv2d(in_ch, out, 1, bias=False),
                                             "1": FrozenBatchNorm2d(out)})

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, self.stride) if self.stride > 1 else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(self._pool(y)))
        s = x
        if self.downsample is not None:
            s = self.downsample["1"](self.downsample["0"](self._pool(x)))
        return F.relu(y + s)


class CLIPAttentionPool(nn.Module):
    """CLIP's AttentionPool2d in the reference's masked form. Heads of 64
    channels; q/k/v/c projections under their open_clip names."""

    def __init__(self, embed_dim: int, output_dim: int, spacial_dim: int = 7):
        super().__init__()
        self.spacial_dim = spacial_dim
        self.positional_embedding = nn.Parameter(
            torch.randn(spacial_dim * spacial_dim + 1, embed_dim) * embed_dim**-0.5)
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.c_proj = Linear(embed_dim, output_dim)

    def forward(self, x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) dense trunk features; masks (B, N, Hm, Wm) logits
        -> (B, N, output_dim)."""
        B, C, H, W = x.shape
        heads, dh, S = C // 64, 64, self.spacial_dim
        d = x.dtype
        pos = self.positional_embedding.to(d)
        # the table's spatial rows resized to the map (jax.image.resize
        # "linear", antialiased where it shrinks, as here)
        spatial = pos[1:].reshape(1, S, S, C).permute(0, 3, 1, 2).float()
        spatial = F.interpolate(spatial, size=(H, W), mode="bilinear", align_corners=False,
                                antialias=True).to(d)
        tokens = x.flatten(2).transpose(1, 2)  # (B, HW, C)
        key_value = tokens + spatial.flatten(2).transpose(1, 2)
        query = tokens.mean(dim=1) + pos[0]  # (B, C)

        allow = (resize_masks(masks, (H, W)) > 0.0).flatten(2)  # (B, N, HW)
        empty = ~allow.any(dim=-1, keepdim=True)
        bias = torch.zeros(allow.shape, dtype=torch.float32, device=x.device)
        bias = bias.masked_fill(~(allow | empty), _NEG_INF)

        q = self.q_proj(query).reshape(B, heads, dh)
        k = self.k_proj(key_value).reshape(B, H * W, heads, dh)
        v = self.v_proj(key_value).reshape(B, H * W, heads, dh)
        # every mask shares the query vector and owns its attention row
        att = torch.einsum("bhd,bshd->bhs", q, k).float() / math.sqrt(dh)
        att = (att[:, :, None, :] + bias[:, None]).softmax(dim=-1).to(d)  # (B, heads, N, HW)
        pooled = torch.einsum("bhns,bshd->bnhd", att, v)
        return self.c_proj(pooled.reshape(B, pooled.shape[1], C))


class ModifiedResNet(nn.Module):
    """CLIP's ModifiedResNet trunk (RN50: layers (3, 4, 6, 3), width 64): a
    3-conv stem (stride 2) and an average pool, then res2 (stride 4, 4w
    channels) .. res5 (stride 32, 32w); ``clip_vis_dense`` = res5. The
    attention pool lives here as ``attnpool``, as in open_clip."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 output_dim: int = 1024, spacial_dim: int = 7):
        super().__init__()
        w = width
        self.conv1 = Conv2d(3, w // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm2d(w // 2)
        self.conv2 = Conv2d(w // 2, w // 2, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(w // 2)
        self.conv3 = Conv2d(w // 2, w, 3, padding=1, bias=False)
        self.bn3 = FrozenBatchNorm2d(w)
        in_ch, planes = w, w
        for s, depth in enumerate(layers):
            blocks = []
            for b in range(depth):
                blocks.append(CLIPBottleneck(in_ch, planes, (1 if s == 0 else 2) if b == 0 else 1))
                in_ch = planes * 4
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.num_stages = len(layers)
        self.attnpool = CLIPAttentionPool(w * 32, output_dim, spacial_dim)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = F.relu(self.bn3(self.conv3(y)))
        y = F.avg_pool2d(y, 2)
        outs = {}
        for s in range(self.num_stages):
            y = getattr(self, f"layer{s + 1}")(y)
            outs[f"res{s + 2}"] = y
        outs["clip_vis_dense"] = y
        return outs


class CLIPBackbone(nn.Module):
    """The frozen CLIP visual trunk as the segmenter's backbone, with its
    out-of-vocabulary head and ``logit_scale``. ``cfg``: a model config
    (``clip_*`` backbone fields and ``ov.clip_embed_dim``). ``clip_model_type``
    picks the trunk: ``convnext`` (mask pooling + MLP head) or ``resnet``
    (masked attention pooling)."""

    def __init__(self, cfg):
        super().__init__()
        b = cfg.backbone
        self.model_type = b.clip_model_type
        self.clip_model = nn.Module()
        if self.model_type == "resnet":
            w = b.clip_resnet_width
            self.clip_model.visual = ModifiedResNet(tuple(b.clip_depths), w, cfg.ov.clip_embed_dim,
                                                    b.clip_attnpool_spacial)
            self.out_channels = {f"res{s + 2}": w * 4 * 2**s for s in range(len(b.clip_depths))}
        elif self.model_type == "convnext":
            self.clip_model.visual = _ConvNeXtVisual(tuple(b.clip_depths), tuple(b.clip_dims),
                                                     cfg.ov.clip_embed_dim)
            self.out_channels = {f"res{s + 2}": d for s, d in enumerate(b.clip_dims)}
        else:
            raise ValueError(f"model.backbone.clip_model_type must be convnext or resnet, "
                             f"got {self.model_type!r}")
        self.clip_model.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        v = self.clip_model.visual
        return (v if self.model_type == "resnet" else v.trunk)(images)

    def pool_clip(self, clip_dense: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """Out-of-vocabulary head: clip_dense (B, C, h, w) stride-32 features,
        masks (B, N, Hm, Wm) logits -> (B, N, clip_embed_dim)."""
        from dvis_plus_tpu_torch.models.ov.heads import mask_pooling

        v = self.clip_model.visual
        if self.model_type == "resnet":
            return v.attnpool(clip_dense, masks)
        return v.head.mlp(v.trunk.head.norm(mask_pooling(clip_dense, masks)))

    @property
    def logit_scale(self) -> torch.Tensor:
        return self.clip_model.logit_scale


class _ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=1e-5)
        self.attn = MultiheadAttention(width, heads)
        self.ln_2 = LayerNorm(width, eps=1e-5)
        self.mlp = nn.Module()
        self.mlp.c_fc = Linear(width, 4 * width)
        self.mlp.c_proj = Linear(4 * width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.ln_1(x)
        x = x + self.attn(h, h, h, mask)
        return x + self.mlp.c_proj(F.gelu(self.mlp.c_fc(self.ln_2(x))))


class CLIPTextEncoder(nn.Module):
    """CLIP text tower: token embedding + causal transformer + ``ln_final``,
    the end-of-text token's state (the highest id of each row) times
    ``text_projection``. fp32."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 768,
                 heads: int = 12, layers: int = 16, embed_dim: int = 768):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.randn(context_length, width) * 0.01)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            _ResidualAttentionBlock(width, heads) for _ in range(layers))
        self.ln_final = LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.randn(width, embed_dim) * width**-0.5)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) integer ids -> (B, embed_dim) fp32 embeddings."""
        B, L = tokens.shape
        x = self.token_embedding(tokens.long()) + self.positional_embedding[None, :L]
        causal = torch.ones(L, L, dtype=torch.bool, device=tokens.device).tril()
        mask = torch.zeros(L, L, device=tokens.device).masked_fill(~causal, _NEG_INF)[None, None]
        for block in self.transformer.resblocks:
            x = block(x, mask)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        return x[torch.arange(B, device=x.device), eot] @ self.text_projection


def text_state_dict(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """An open_clip text-tower state dict (plain CLIP names, or the
    ``text.``-prefixed CustomTextCLIP ones of the ConvNeXt checkpoints) ->
    a state dict for :class:`CLIPTextEncoder`; the port's counterpart of
    ``convert_open_clip_text`` (:428). Other keys (the visual tower,
    ``logit_scale``) are left out."""
    keys = ("token_embedding.", "positional_embedding", "transformer.resblocks.", "ln_final.",
            "text_projection")
    out = {}
    for k, v in sd.items():
        name = k[len("text."):] if k.startswith("text.") else k
        if name.startswith(keys):
            out[name] = torch.as_tensor(np.asarray(v, np.float32))
    return out


def text_encoder_for(sd: Mapping[str, torch.Tensor]) -> CLIPTextEncoder:
    """A :class:`CLIPTextEncoder` shaped for the text state dict ``sd`` (from
    :func:`text_state_dict`): the layer count from its resblock keys, the
    widths from its tables, 64-channel heads (as the JAX CLI builds its
    encoder), with ``sd`` loaded."""
    layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")})
    ctx, width = sd["positional_embedding"].shape
    enc = CLIPTextEncoder(vocab_size=sd["token_embedding.weight"].shape[0], context_length=ctx,
                          width=width, heads=width // 64, layers=layers,
                          embed_dim=sd["text_projection"].shape[1])
    enc.load_state_dict(sd, strict=True)
    return enc
