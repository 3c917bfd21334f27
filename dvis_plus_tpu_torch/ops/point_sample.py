"""Point sampling for the point-supervised mask losses.

Counterpart: ``dvis_plus_tpu/ops/point_sample.py`` (``point_sample`` :16,
``uncertain_point_coords_with_randomness`` :90), detectron2's point_rend
sampling as the reference criterion uses it: bilinear samples at
normalized [0, 1] coordinates (``align_corners=False``, zero padding), and
importance sampling of the points where the predicted logits are least
certain (-|logit|), topped up with uniform ones.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def point_sample(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """masks (..., H, W) float or bool; coords (..., P, 2) in [0, 1], (x, y),
    whose leading shape broadcasts to the masks'. Returns (..., P): float32
    for bool masks, else the masks' dtype. A point set shared along the last
    leading axis (coords' size 1 there) is sampled once for all of it, the
    axis taken as channels."""
    lead, (H, W) = masks.shape[:-2], masks.shape[-2:]
    P = coords.shape[-2]
    coords = coords.float()
    if not masks.is_floating_point():
        return _sample_binary(masks, coords)
    if lead and coords.dim() == masks.dim() and coords.shape[-3] == 1:
        outer = torch.broadcast_shapes(coords.shape[:-3], lead[:-1])
        m = masks.expand(*outer, *lead[-1:], H, W).reshape(-1, lead[-1], H, W)
        g = coords.expand(*outer, 1, P, 2).reshape(-1, 1, P, 2)
        out_lead = (*outer, lead[-1])
    else:
        out_lead = torch.broadcast_shapes(coords.shape[:-2], lead)
        m = masks.expand(*out_lead, H, W).reshape(-1, 1, H, W)
        g = coords.expand(*out_lead, P, 2).reshape(-1, 1, P, 2)
    out = F.grid_sample(m, (2.0 * g - 1.0).to(m.dtype), mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.reshape(*out_lead, P)


def _sample_binary(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """:func:`point_sample` of bool or integer masks by four scalar gathers a
    point (the JAX function's branch for ground-truth volumes), so that no
    float copy of the full-resolution masks is made."""
    H, W = masks.shape[-2:]
    x = coords[..., 0] * W - 0.5
    y = coords[..., 1] * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    x0i, y0i = x0.long(), y0.long()
    inb = (x0i >= -1) & (x0i < W) & (y0i >= -1) & (y0i < H)
    yi, xi = (y0i + 1).clamp(0, H), (x0i + 1).clamp(0, W)
    out_lead = torch.broadcast_shapes(coords.shape[:-2], masks.shape[:-2])
    flat = masks.expand(*out_lead, H, W).reshape(*out_lead, H * W)

    def corner(yc, xc, wy, wx):
        valid = (yc >= 1) & (yc <= H) & (xc >= 1) & (xc <= W) & inb
        idx = (yc - 1).clamp(0, H - 1) * W + (xc - 1).clamp(0, W - 1)
        g = torch.gather(flat, -1, idx.expand(*out_lead, idx.shape[-1])).float()
        return g * (wy * wx * valid.float())

    return (corner(yi, xi, wy0, wx0) + corner(yi, xi + 1, wy0, wx1)
            + corner(yi + 1, xi, wy1, wx0) + corner(yi + 1, xi + 1, wy1, wx1))


def uncertain_point_coords_with_randomness(
    logits: torch.Tensor,
    num_points: int,
    oversample_ratio: float,
    importance_sample_ratio: float,
    generator: Optional[torch.Generator] = None,
    coords: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """logits (N, H, W) -> (N, num_points, 2) coordinates in [0, 1], (x, y):
    the ``importance_sample_ratio`` share of the points, picked most uncertain
    first (lower index first among equals, as ``jax.lax.top_k``) from
    ``num_points * oversample_ratio`` uniform candidates, then uniform fill.
    ``coords`` = (candidates (N, n_over, 2), fill (N, n_fill, 2)) replaces the
    draws from ``generator``."""
    N = logits.shape[0]
    num_sampled = int(num_points * oversample_ratio)
    num_uncertain = int(importance_sample_ratio * num_points)
    num_random = num_points - num_uncertain
    if coords is None:
        kw = dict(generator=generator, device=logits.device)
        coords = (torch.rand(N, num_sampled, 2, **kw), torch.rand(N, num_random, 2, **kw))
    over, fill = coords
    uncertainty = -point_sample(logits, over).abs()
    idx = uncertainty.sort(dim=1, descending=True, stable=True).indices[:, :num_uncertain]
    picked = torch.gather(over, 1, idx[..., None].expand(-1, -1, 2))
    return torch.cat([picked, fill], dim=1) if num_random > 0 else picked
