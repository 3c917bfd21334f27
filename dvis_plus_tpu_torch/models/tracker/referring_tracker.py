"""Referring tracker (DVIS++ online stage 2), inference path.

Counterpart: ``dvis_plus_tpu/models/tracker/referring_tracker.py``
(``TrackerState`` :44, ``match_embds`` :57, ``ReferringCrossAttentionLayer``
:148, ``_FrameStep`` :160, ``ReferringTracker`` :224). Per frame: align the
segmenter's queries to the previous frame by a cosine-cost assignment, then
``num_layers`` x [referring cross-attention -> self-attention -> FFN]. The
JAX ``nn.scan`` over frames is a Python loop here, and the carry
(:class:`TrackerState`) is passed back in by the caller across windows.

Eval only: no training noiser and no rematerialisation (training is not
ported yet). Parameter names follow the reference ``dvis_Plus/tracker.py``.

``ov=True`` is the open-vocabulary tracker (:263-345, the reference
``ReferringTracker_noiser_OV``): no ``mask_feature_proj`` (the masks are
taken against the segmenter's raw mask features), and the class head is
``merge`` (concat(reference, output) -> C), plus the raw mask features
pooled under each predicted mask through ``_mask_pooling_proj``, mapped
into CLIP space by ``class_embed`` and scored against the text classifier
(``models/ov/ov_decoder.py::add_ov_head``; ``zoo_convert.py::convert_ov_tracker``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from dvis_plus_tpu_torch.models.layers import Conv2d, LayerNorm, Linear
from dvis_plus_tpu_torch.models.ov.heads import mask_pooling
from dvis_plus_tpu_torch.models.ov.ov_decoder import add_ov_head, ov_head_logits
from dvis_plus_tpu_torch.models.segmenter.transformer_decoder import (
    MLP,
    FFNLayer,
    MultiheadAttention,
    SelfAttentionLayer,
)
from dvis_plus_tpu_torch.ops.assignment import auction_lap
from dvis_plus_tpu_torch.ops.hungarian import hungarian


class TrackerState(NamedTuple):
    """Streaming carry across frames and windows."""

    last_output: torch.Tensor  # (B, Q, C) last-layer output of the previous frame
    last_frame_embeds: torch.Tensor  # (B, Q, C) aligned segmenter embeds
    is_first: bool  # the next frame starts a new video


def init_tracker_state(B: int, Q: int, C: int, dtype=torch.float32, device=None) -> TrackerState:
    z = torch.zeros(B, Q, C, dtype=dtype, device=device)
    return TrackerState(last_output=z, last_frame_embeds=z, is_first=True)


def match_embds(ref: torch.Tensor, cur: torch.Tensor, solver: str = "auction") -> torch.Tensor:
    """(Q, C) x (Q, C) -> permutation (Q_ref,) of current query indices
    aligning cur to ref. solver: ``auction`` or ``jv`` (exact, scipy)."""
    ref_n = ref / (torch.linalg.norm(ref, dim=1, keepdim=True) + 1e-6)
    cur_n = cur / (torch.linalg.norm(cur, dim=1, keepdim=True) + 1e-6)
    C = 1.0 - cur_n @ ref_n.T  # (Q_cur, Q_ref)
    C = torch.where(torch.isnan(C), torch.zeros_like(C), C)
    if solver == "jv":
        return hungarian(C.T.float())[0]
    if solver != "auction":
        raise ValueError(f"matcher_solver must be auction or jv, got {solver}")
    return auction_lap(C.T.float())


class ReferringCrossAttentionLayer(nn.Module):
    """identity + MHA(q=tgt, k=key, v=memory), post-norm."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(dim, num_heads)
        self.norm = LayerNorm(dim, eps=1e-5)

    def forward(self, identity, tgt, key, memory):
        return self.norm(identity + self.multihead_attn(tgt, key, memory))


class ReferringTracker(nn.Module):
    def __init__(self, num_classes: int, hidden_dim: int = 256, feedforward_dim: int = 2048,
                 num_heads: int = 8, num_layers: int = 6, mask_dim: int = 256,
                 mask_in_dim: int = 256, matcher: str = "auction", ov: bool = False,
                 clip_embed_dim: int = 768):
        super().__init__()
        C = hidden_dim
        self.num_layers, self.matcher = num_layers, matcher
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(C, num_heads) for _ in range(num_layers)
        )
        self.transformer_cross_attention_layers = nn.ModuleList(
            ReferringCrossAttentionLayer(C, num_heads) for _ in range(num_layers)
        )
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(C, feedforward_dim) for _ in range(num_layers)
        )
        self.ref_proj = MLP(C, C, C, 3)
        self.decoder_norm = LayerNorm(C, eps=1e-5)
        self.mask_embed = MLP(C, C, mask_dim, 3)
        self.ov = ov
        if ov:
            self.merge = Linear(2 * C, C)
            add_ov_head(self, mask_in_dim, C, clip_embed_dim)
        else:
            self.class_embed = Linear(2 * C, num_classes + 1)
            self.mask_feature_proj = Conv2d(mask_in_dim, mask_dim, 1)

    def frame_step(self, state: TrackerState, cur: torch.Tensor, cur_nn: torch.Tensor):
        """One recurrent frame: cur / cur_nn (B, Q, C) normed / raw segmenter
        embeds. Returns (last-layer output, reference, indices, new state)."""
        B = cur.shape[0]
        first = state.is_first
        ref_for_match = cur if first else state.last_frame_embeds
        idx = torch.stack(
            [match_embds(ref_for_match[b], cur[b], self.matcher) for b in range(B)]
        )  # (B, Q)
        gather_idx = idx[..., None].expand(-1, -1, cur.shape[-1])
        init = torch.gather(cur_nn, 1, gather_idx)
        aligned = torch.gather(cur, 1, gather_idx)

        frame_key = cur_nn
        reference = self.ref_proj(frame_key if first else state.last_output)
        output = init
        for j in range(self.num_layers):
            if j == 0:
                identity, tgt = init, reference
            else:
                identity = output
                tgt = self.ref_proj(output) if first else reference
            output = self.transformer_cross_attention_layers[j](identity, tgt, frame_key, frame_key)
            output = self.transformer_self_attention_layers[j](output)
            output = self.transformer_ffn_layers[j](output)
        new_state = TrackerState(last_output=output, last_frame_embeds=aligned, is_first=False)
        return output, reference, idx, new_state

    def forward(
        self,
        frame_embeds: torch.Tensor,  # (B, T, Q, C) normed segmenter embeds
        mask_features: torch.Tensor,  # (B, T, mask_in_dim, H, W)
        frame_embeds_no_norm: Optional[torch.Tensor] = None,
        state: Optional[TrackerState] = None,  # None = video start
        predict_masks: bool = True,  # False: no mask head (the offline path)
        text_classifier: Optional[torch.Tensor] = None,  # ov: (R, Cc) with the void rows
        num_templates: Optional[Sequence[int]] = None,  # ov
    ) -> Tuple[Dict[str, torch.Tensor], TrackerState]:
        """With ``ov`` the class logits need the masks: without
        ``predict_masks`` there are none."""
        B, T, Q, C = frame_embeds.shape
        if frame_embeds_no_norm is None:
            frame_embeds_no_norm = frame_embeds
        dtype = frame_embeds.dtype
        if state is None:
            state = init_tracker_state(B, Q, C, dtype, frame_embeds.device)
        else:
            state = TrackerState(
                state.last_output.to(dtype), state.last_frame_embeds.to(dtype), state.is_first
            )

        outputs, references, indices = [], [], []
        for t in range(T):
            out_t, ref_t, idx_t, state = self.frame_step(
                state, frame_embeds[:, t], frame_embeds_no_norm[:, t]
            )
            outputs.append(out_t)
            references.append(ref_t)
            indices.append(idx_t)
        emit = torch.stack(outputs, dim=1)  # (B, T, Q, C)
        refs = torch.stack(references, dim=1)

        x = self.decoder_norm(emit)
        cls_in = torch.cat([refs, x], dim=-1)
        out = {
            "pred_embds": emit,
            "pred_references": refs,
            "indices": torch.stack(indices, dim=1),  # (B, T, Q)
        }
        if not self.ov:
            out["pred_logits"] = self.class_embed(cls_in)  # (B, T, Q, K+1)
        if predict_masks:
            mf = mask_features
            if not self.ov:
                mf = self.mask_feature_proj(mask_features.flatten(0, 1))
                mf = mf.reshape(B, T, *mf.shape[1:])
            membd = self.mask_embed(x)
            # (B, Q, T, H, W) fp32
            masks = torch.einsum("btqc,btchw->bqthw", membd.float(), mf.float())
            out["pred_masks"] = masks
            if self.ov:
                pooled = mask_pooling(mf.flatten(0, 1), masks.transpose(1, 2).flatten(0, 1))
                out["pred_logits"] = ov_head_logits(
                    self, pooled.reshape(B, T, Q, -1), self.merge(cls_in), text_classifier,
                    num_templates)  # (B, T, Q, K+1) fp32
        return out, state
