"""2D image and 3D video sine position encodings.

Counterpart: ``dvis_plus_tpu/models/segmenter/position_encoding.py``
(``position_embedding_sine_2d`` :27, ``position_embedding_sine_3d`` :47).
Channel-last output, as there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _sine_embed(coord: torch.Tensor, num_pos_feats: int, temperature: float) -> torch.Tensor:
    """coord (...,) -> (..., num_pos_feats), interleaved sin/cos."""
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=coord.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    pos = coord[..., None] / dim_t
    return torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], dim=-1).reshape(
        *pos.shape[:-1], -1
    )


def position_embedding_sine_2d(
    H: int,
    W: int,
    num_pos_feats: int,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float = 2.0 * math.pi,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """(H, W, 2*num_pos_feats) with [pos_y, pos_x] channel concat."""
    y = torch.arange(1, H + 1, dtype=torch.float32, device=device)[:, None].expand(H, W)
    x = torch.arange(1, W + 1, dtype=torch.float32, device=device)[None, :].expand(H, W)
    if normalize:
        eps = 1e-6
        y = y / (H + eps) * scale
        x = x / (W + eps) * scale
    return torch.cat(
        [_sine_embed(y, num_pos_feats, temperature), _sine_embed(x, num_pos_feats, temperature)],
        dim=-1,
    )


def position_embedding_sine_3d(
    T: int,
    H: int,
    W: int,
    channels: int,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float = 2.0 * math.pi,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """(T, H, W, channels) video PE: concat(pos_y, pos_x) of channels/2 each,
    plus a temporal embedding pos_z over the full width."""
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.arange(1, T + 1, **f32)[:, None, None].expand(T, H, W)
    y = torch.arange(1, H + 1, **f32)[None, :, None].expand(T, H, W)
    x = torch.arange(1, W + 1, **f32)[None, None, :].expand(T, H, W)
    if normalize:
        eps = 1e-6
        z = z / (T + eps) * scale
        y = y / (H + eps) * scale
        x = x / (W + eps) * scale
    n_spatial = channels // 2
    spatial = torch.cat(
        [_sine_embed(y, n_spatial, temperature), _sine_embed(x, n_spatial, temperature)], dim=-1
    )
    return spatial + _sine_embed(z, channels, temperature)
