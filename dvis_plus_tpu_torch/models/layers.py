"""Layers whose compute follows the caller's dtype.

The JAX package keeps its parameters in fp32 and computes each layer in the
dtype its caller cast the input to (flax ``dtype=`` / AMP-style bf16 with
fp32 islands). These thin subclasses do the same in PyTorch: the weight is
cast to the input's dtype at the call (a no-op when they match), and layer
norms reduce in fp32 and return the input's dtype, as flax's ``LayerNorm``
does. Parameter names are PyTorch's own, so a module's ``state_dict`` keeps
the reference checkpoints' key space.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class Conv2d(nn.Conv2d):
    """detectron2-style conv: an optional ``norm`` child (named as in the
    reference checkpoints, e.g. ``res2.0.conv1.norm``) applied after the
    convolution."""

    def __init__(self, *args, norm: Optional[nn.Module] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = self._conv_forward(x, self.weight.to(x.dtype), b)
        return y if self.norm is None else self.norm(y)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class Conv1d(nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with frozen statistics: a per-channel affine computed in fp32
    and applied in the input's dtype (``dvis_plus_tpu/models/backbones/
    resnet.py::FrozenBN``, eps 1e-5). Buffers carry detectron2's names."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = (self.running_var + self.eps) ** -0.5
        mul = (self.weight * inv).to(x.dtype)
        add = (self.bias - self.running_mean * self.weight * inv).to(x.dtype)
        return x * mul[None, :, None, None] + add[None, :, None, None]
