"""ResNet backbone, detectron2 style (caffe stride-in-1x1 bottlenecks, frozen
BatchNorm), NCHW.

Counterpart: ``dvis_plus_tpu/models/backbones/resnet.py`` (``FrozenBN`` :22,
``Bottleneck`` :45, ``ResNet`` :81), which is NHWC. Module and buffer names
follow detectron2 (``stem.conv1``, ``res2.0.conv1.norm``,
``res2.0.shortcut``), the key space of the reference checkpoints.
Convolutions compute in the input's dtype (the caller casts the images to
``model.compute_dtype``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dvis_plus_tpu_torch.models.layers import Conv2d, FrozenBatchNorm2d


class BasicStem(nn.Module):
    def __init__(self, width: int = 64):
        super().__init__()
        self.conv1 = Conv2d(
            3, width, 7, stride=2, padding=3, bias=False, norm=FrozenBatchNorm2d(width)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(x))
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int,
                 stride: int = 1, stride_in_1x1: bool = True, dilation: int = 1):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.shortcut = None
        if in_channels != out_channels or stride != 1:
            self.shortcut = Conv2d(
                in_channels, out_channels, 1, stride=stride, bias=False,
                norm=FrozenBatchNorm2d(out_channels),
            )
        self.conv1 = Conv2d(
            in_channels, bottleneck_channels, 1, stride=s1, bias=False,
            norm=FrozenBatchNorm2d(bottleneck_channels),
        )
        self.conv2 = Conv2d(
            bottleneck_channels, bottleneck_channels, 3, stride=s3, padding=dilation,
            dilation=dilation, bias=False, norm=FrozenBatchNorm2d(bottleneck_channels),
        )
        self.conv3 = Conv2d(
            bottleneck_channels, out_channels, 1, bias=False,
            norm=FrozenBatchNorm2d(out_channels),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        y = self.conv3(y)
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    """R50/R101 pyramid backbone. Input (N, 3, H, W); output {res2..res5}."""

    def __init__(self, depths: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 stride_in_1x1: bool = True,
                 out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")):
        super().__init__()
        self.out_features = tuple(out_features)
        self.stem = BasicStem(width)
        in_ch, out_ch, bott = width, width * 4, width
        self.stage_names = []
        self.out_channels: Dict[str, int] = {}  # per-level output widths
        for s, depth in enumerate(depths):
            blocks = []
            for b in range(depth):
                blocks.append(Bottleneck(
                    in_ch if b == 0 else out_ch, out_ch, bott,
                    stride=(1 if s == 0 else 2) if b == 0 else 1,
                    stride_in_1x1=stride_in_1x1,
                ))
            name = f"res{s + 2}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            if name in self.out_features:
                self.out_channels[name] = out_ch
            in_ch, out_ch, bott = out_ch, out_ch * 2, bott * 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = self.stem(x)
        outs = {}
        for name in self.stage_names:
            y = getattr(self, name)(y)
            if name in self.out_features:
                outs[name] = y
        return outs


def resnet50(**kw) -> ResNet:
    return ResNet(depths=(3, 4, 6, 3), **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(depths=(3, 4, 23, 3), **kw)
