"""Layers of the plain reference: fp32 PyTorch, no kernel.

A frozen copy of what the benchmarked package's ``models/layers.py`` computes
(each layer in its input's dtype; norms reduce in fp32), taken so that a later
change to the package cannot move the yardstick. It imports nothing of the
package.

``set_precision("fp8")`` turns the reference into the correctness check's
control: every linear and convolution layer (the attention projections
included) and every product of the model (attention scores and their
weighted sums, the mask heads' einsums) rounds both operands to float8 e4m3,
each scaled by its own absolute maximum, the way an fp8 GEMM would take
them. The post-processing after the model stays fp32. ``"fp32"``, the
default, leaves them alone.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

_PRECISION = "fp32"
_E4M3_MAX = 448.0


def set_precision(name: str) -> None:
    global _PRECISION
    if name not in ("fp32", "fp8"):
        raise ValueError(f"precision must be fp32 or fp8, got {name!r}")
    _PRECISION = name


def precision() -> str:
    return _PRECISION


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with a per-tensor scale, back in its dtype."""
    if _PRECISION != "fp8" or x.device.type == "meta":
        return x
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / _E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with both operands through :func:`fake_fp8`."""
    return torch.matmul(fake_fp8(a), fake_fp8(b))


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands, both through :func:`fake_fp8`."""
    return torch.einsum(eq, fake_fp8(a), fake_fp8(b))


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    b = None if b is None else b.to(x.dtype)
    return F.linear(fake_fp8(x), fake_fp8(w.to(x.dtype)), b)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class Conv2d(nn.Conv2d):
    """A convolution with an optional ``norm`` child applied after it."""

    def __init__(self, *args, norm: Optional[nn.Module] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = self._conv_forward(fake_fp8(x), fake_fp8(self.weight.to(x.dtype)), b)
        return y if self.norm is None else self.norm(y)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(fake_fp8(x), fake_fp8(self.weight.to(x.dtype)), b,
                                  self.stride, self.padding)


class Conv1d(nn.Conv1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(fake_fp8(x), fake_fp8(self.weight.to(x.dtype)), b)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with frozen statistics (eps 1e-5), an affine computed in fp32."""

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
