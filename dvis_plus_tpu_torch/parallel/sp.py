"""The offline refiner's eval pass with its objects sharded over devices.

Counterpart: ``dvis_plus_tpu/parallel/sp.py::refiner_embed_pass_sharded``
(:31-88) with ``TemporalRefiner._body(axis_name=)`` (``temporal_refiner.py``
:143-195). The refiner's temporal self-attention is dense over the whole
video, O(T^2) a query (reference ``DVIS_Plus/dvis_Plus/refiner.py:108-113``;
the reference refines a video on one GPU). Here the queries are split into
contiguous shards, one a device, in one process:

- the temporal self-attention, the conv block, the cross-attention to the
  frame's segmenter queries, the FFN and the heads are object-local, so a
  shard runs them on its device alone (the T^2 work and the O(T·Q·C)
  activations divide by the shard count);
- only the per-frame object self-attention needs the other shards: its
  keys and values are every shard's queries, copied to each device (one
  (B·T, Q, C) gather a layer), its queries stay the shard's own.

Q is padded with zero rows to a multiple of the shard count; the padded
rows are masked out of the object attention's keys and dropped from the
outputs. A device that is not the refiner's own gets a copy of it.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from dvis_plus_tpu_torch.models.refiner.temporal_refiner import TemporalRefiner, object_bias


def shard_devices(n: int, home: torch.device) -> List[torch.device]:
    """The devices of ``test.refiner_shard_devices=n``: ``cuda:0 .. n-1``
    (raising where there are fewer cards; nothing falls back to one), or
    the CPU n times."""
    if home.type != "cuda":
        return [home] * n
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"test.refiner_shard_devices={n} but {torch.cuda.device_count()} cards")
    return [torch.device("cuda", i) for i in range(n)]


def refiner_embed_pass_sharded(refiner: TemporalRefiner, instance_embeds: torch.Tensor,
                               frame_embeds: torch.Tensor, devices: Sequence[torch.device],
                               instance_mask: Optional[torch.Tensor] = None,
                               time_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """``refiner.embed_pass`` with the Q axis of ``instance_embeds`` (B, T,
    Q, C) split over ``devices`` (one shard each; a device may repeat);
    ``frame_embeds`` (B, T, fQ, C), ``instance_mask`` (B, Q), ``time_mask``
    (B, T) as there. Returns the same outputs over every Q, on the input's
    device."""
    B, T, Q, C = instance_embeds.shape
    home = instance_embeds.device
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    q = -(-Q // n)
    if instance_mask is None:
        instance_mask = torch.ones(B, Q, dtype=torch.bool, device=home)
    ie = F.pad(instance_embeds, (0, 0, 0, q * n - Q))
    mask = F.pad(instance_mask, (0, q * n - Q), value=False)
    own = next(refiner.parameters()).device
    copies = {}
    reps = [refiner if d == own else copies.setdefault(d, copy.deepcopy(refiner).to(d))
            for d in devices]
    obj = [object_bias(mask.to(d), T) for d in devices]
    mem = [refiner.frame_memory(frame_embeds.to(d)) for d in devices]
    time = [refiner.time_masks(None if time_mask is None else time_mask.to(d), q) for d in devices]
    outs = [ie[:, :, s * q:(s + 1) * q].to(d) for s, d in enumerate(devices)]
    for i in range(refiner.num_layers):
        xs = [r.temporal_part(i, o, t) for r, o, t in zip(reps, outs, time)]
        for s, (r, d) in enumerate(zip(reps, devices)):
            kv = torch.cat([x.to(d) for x in xs], dim=1)  # every shard's queries, (B*T, Qp, C)
            x = r.transformer_obj_self_attention_layers[i](xs[s], mask=obj[s], kv=kv)
            outs[s] = r.frame_part(i, x, mem[s], outs[s].shape)
    heads = [r.embed_heads(o, None if time_mask is None else time_mask.to(d))
             for r, o, d in zip(reps, outs, devices)]
    # pred_logits (B, Q, K+1) shard their axis 1; the others (B, T|1, Q, X) axis 2
    return {k: torch.cat([h[k].to(home) for h in heads], dim=1 if k == "pred_logits" else 2)
            .narrow(1 if k == "pred_logits" else 2, 0, Q) for k in heads[0]}
