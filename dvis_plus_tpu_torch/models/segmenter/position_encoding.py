"""2D sine position encoding.

Counterpart: ``dvis_plus_tpu/models/segmenter/position_encoding.py::
position_embedding_sine_2d`` (:27). Channel-last output, as there.
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
