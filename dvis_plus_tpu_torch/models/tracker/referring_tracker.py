"""Referring tracker (DVIS++ online stage 2), inference path.

Counterpart: ``dvis_plus_tpu/models/tracker/referring_tracker.py``
(``TrackerState`` :44, ``match_embds`` :57, ``ReferringCrossAttentionLayer``
:148, ``_FrameStep`` :160, ``ReferringTracker`` :224). Per frame: align the
segmenter's queries to the previous frame by a cosine-cost assignment, then
``num_layers`` x [referring cross-attention -> self-attention -> FFN]. The
JAX ``nn.scan`` over frames is a Python loop here, and the carry
(:class:`TrackerState`) is passed back in by the caller across windows.

Training (``draws`` given): the noiser of :57-145 (:func:`noiser`, modes
``none`` / ``rs`` / ``wa`` / ``cc``, ``hard`` read as ``wa``) replaces the
alignment of a frame but the first by a shuffle with probability
``noise_ratio``, every layer's output is emitted (the auxiliary logits and
masks of the deep supervision), and the referring decoder of a frame runs
under ``torch.utils.checkpoint`` (the JAX step's ``nn.remat``): its
activations are recomputed in the backward pass. The alignment and the
noise are drawn outside the checkpointed part, so the recomputation replays
them. Parameter names follow the reference ``dvis_Plus/tracker.py``.

``ov=True`` is the open-vocabulary tracker (:263-362, the reference
``ReferringTracker_noiser_OV``): no ``mask_feature_proj`` (the masks are
taken against the segmenter's raw mask features), and the class head is
``merge`` (concat(reference, output) -> C), plus the raw mask features
pooled under each predicted mask (binary, no gradient through the mask)
through ``_mask_pooling_proj``, mapped into CLIP space by ``class_embed``
and scored against the text classifier
(``models/ov/ov_decoder.py::add_ov_head``; ``zoo_convert.py::convert_ov_tracker``);
in training every layer's masks and logits, as the closed tracker's.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint

from dvis_plus_tpu_torch.models.layers import Conv2d, LayerNorm, Linear
from dvis_plus_tpu_torch.models.ov.heads import binary_mask_pooling
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
    aligning cur to ref; (B, Q, C) x (B, Q, C) -> (B, Q), B problems (one
    auction for all of them). solver: ``auction`` or ``jv`` (exact, scipy)."""
    ref_n = ref / (torch.linalg.norm(ref, dim=-1, keepdim=True) + 1e-6)
    cur_n = cur / (torch.linalg.norm(cur, dim=-1, keepdim=True) + 1e-6)
    C = 1.0 - cur_n @ ref_n.transpose(-1, -2)  # (..., Q_cur, Q_ref)
    C = torch.where(torch.isnan(C), torch.zeros_like(C), C).transpose(-1, -2).float()
    if solver == "jv":
        if C.dim() == 2:
            return hungarian(C)[0]
        return torch.stack([hungarian(c)[0] for c in C])
    if solver != "auction":
        raise ValueError(f"matcher_solver must be auction or jv, got {solver}")
    return auction_lap(C)


def _wa_compose(cur_no_norm: torch.Tensor, perm: torch.Tensor, w: torch.Tensor):
    """'wa' given a shuffle ``perm`` (Q,) and weights ``w`` (Q, 1): init =
    cur * w + cur[perm] * (1 - w); the index takes the shuffle where w < 0.5."""
    Q = cur_no_norm.shape[0]
    w = w.to(cur_no_norm.dtype)
    init = cur_no_norm * w + cur_no_norm[perm] * (1.0 - w)
    idx = torch.where(w[:, 0] < 0.5, perm, torch.arange(Q, device=perm.device))
    return idx, init


def _cc_compose(cur_no_norm: torch.Tensor, perm: torch.Tensor, split: torch.Tensor):
    """'cc' given a shuffle ``perm`` (Q,) and channel split points ``split``
    (Q, 1): the first split channels are the query's own, the rest the
    shuffled one's; the index takes the shuffle where split < C // 2."""
    Q, C = cur_no_norm.shape
    keep = (torch.arange(C, device=split.device)[None, :] < split).to(cur_no_norm.dtype)
    init = cur_no_norm * keep + cur_no_norm[perm] * (1.0 - keep)
    idx = torch.where(split[:, 0] < C // 2, perm, torch.arange(Q, device=perm.device))
    return idx, init


def noiser(matched: torch.Tensor, cur_no_norm: torch.Tensor, use_noise: torch.Tensor, mode: str,
           draws, t: int):
    """(indices (B, Q), init (B, Q, C)) of a frame: the assignment ``matched``
    (B, Q), or where ``use_noise`` (B,) the noise of ``mode`` (rs: a
    shuffle; wa: a weighted average with a shuffle; cc: a channel crossover
    with a shuffle), drawn from ``draws`` under ``("noise", t, ...)``."""
    B, Q, C = cur_no_norm.shape
    gather = lambda x, i: torch.gather(x, 1, i[..., None].expand(-1, -1, C))  # noqa: E731
    init = gather(cur_no_norm, matched)
    if mode == "none":
        return matched, init
    perm = draws.permutation(("noise", t, "perm"), B, Q).to(matched.device)
    if mode == "rs":
        n_idx, n_init = perm, gather(cur_no_norm, perm)
    elif mode == "wa":
        w = draws.uniform(("noise", t, "weight"), (B, Q, 1)).to(cur_no_norm.device)
        n_idx, n_init = zip(*(_wa_compose(cur_no_norm[b], perm[b], w[b]) for b in range(B)))
    elif mode == "cc":
        split = draws.randint(("noise", t, "split"), 0, C, (B, Q, 1)).to(cur_no_norm.device)
        n_idx, n_init = zip(*(_cc_compose(cur_no_norm[b], perm[b], split[b]) for b in range(B)))
    else:
        raise ValueError(f"noise_mode must be none, rs, wa, cc or hard, got {mode}")
    n_idx, n_init = torch.stack(list(n_idx)), torch.stack(list(n_init))
    use = use_noise.to(matched.device)
    return (torch.where(use[:, None], n_idx, matched),
            torch.where(use[:, None, None], n_init, init))


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
                 clip_embed_dim: int = 768, noise_ratio: float = 0.5, noise_mode: str = "wa"):
        super().__init__()
        C = hidden_dim
        self.num_layers, self.matcher = num_layers, matcher
        self.noise_ratio = noise_ratio
        self.noise_mode = "wa" if noise_mode == "hard" else noise_mode
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

    def align(self, state: TrackerState, cur: torch.Tensor, cur_nn: torch.Tensor,
              draws=None, t: int = 0):
        """The frame's (indices (B, Q), init (B, Q, C), aligned embeds): the
        assignment of cur to the previous frame, noised in training
        (``draws`` given) on a frame but a video's first."""
        B = cur.shape[0]
        first = state.is_first
        ref_for_match = cur if first else state.last_frame_embeds
        with torch.no_grad():
            idx = match_embds(ref_for_match, cur, self.matcher)  # (B, Q)
        if draws is not None and not first:
            use_noise = draws.uniform(("noise", t, "gate"), (B,)).to(cur.device) < self.noise_ratio
            idx, init = noiser(idx, cur_nn, use_noise, self.noise_mode, draws, t)
        else:
            init = torch.gather(cur_nn, 1, idx[..., None].expand(-1, -1, cur.shape[-1]))
        aligned = torch.gather(cur, 1, idx[..., None].expand(-1, -1, cur.shape[-1]))
        return idx, init.to(cur.dtype), aligned

    def decode(self, init: torch.Tensor, frame_key: torch.Tensor, last_output: torch.Tensor,
               first: bool):
        """The referring decoder of one frame: (every layer's output (L, B,
        Q, C), the reference)."""
        reference = self.ref_proj(frame_key if first else last_output)
        outputs, output = [], init
        for j in range(self.num_layers):
            if j == 0:
                identity, tgt = init, reference
            else:
                identity = output
                tgt = self.ref_proj(output) if first else reference
            output = self.transformer_cross_attention_layers[j](identity, tgt, frame_key, frame_key)
            output = self.transformer_self_attention_layers[j](output)
            output = self.transformer_ffn_layers[j](output)
            outputs.append(output)
        return torch.stack(outputs), reference

    def frame_step(self, state: TrackerState, cur: torch.Tensor, cur_nn: torch.Tensor,
                   draws=None, t: int = 0):
        """One recurrent frame: cur / cur_nn (B, Q, C) normed / raw segmenter
        embeds. Returns (every layer's output (L, B, Q, C), reference,
        indices, new state); in training (``draws`` given) the decoder is
        checkpointed."""
        idx, init, aligned = self.align(state, cur, cur_nn, draws, t)
        if draws is None:
            outputs, reference = self.decode(init, cur_nn, state.last_output, state.is_first)
        else:
            outputs, reference = torch.utils.checkpoint.checkpoint(
                self.decode, init, cur_nn, state.last_output, state.is_first, use_reentrant=False)
        new_state = TrackerState(last_output=outputs[-1], last_frame_embeds=aligned, is_first=False)
        return outputs, reference, idx, new_state

    def forward(
        self,
        frame_embeds: torch.Tensor,  # (B, T, Q, C) normed segmenter embeds
        mask_features: torch.Tensor,  # (B, T, mask_in_dim, H, W)
        frame_embeds_no_norm: Optional[torch.Tensor] = None,
        state: Optional[TrackerState] = None,  # None = video start
        predict_masks: bool = True,  # False: no mask head (the offline path)
        text_classifier: Optional[torch.Tensor] = None,  # ov: (R, Cc) with the void rows
        num_templates: Optional[Sequence[int]] = None,  # ov
        draws=None,  # training: the noise's draws (utils.draws)
    ) -> Tuple[Dict[str, torch.Tensor], TrackerState]:
        """With ``ov`` the class logits need the masks: without
        ``predict_masks`` there are none. In training (``draws`` given) the
        outputs also hold ``aux_pred_logits`` and ``aux_pred_masks``, one
        entry a layer before the last (with ``ov`` each layer's logits from
        its own masks)."""
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

        training = draws is not None
        outputs, references, indices = [], [], []
        for t in range(T):
            out_t, ref_t, idx_t, state = self.frame_step(
                state, frame_embeds[:, t], frame_embeds_no_norm[:, t], draws, t
            )
            outputs.append(out_t if training else out_t[-1:])
            references.append(ref_t)
            indices.append(idx_t)
        emit = torch.stack(outputs, dim=2)  # (L', B, T, Q, C): every layer in training
        refs = torch.stack(references, dim=1)

        x = self.decoder_norm(emit)
        cls_in = torch.cat([refs.expand_as(x), x], dim=-1)
        out = {
            "pred_embds": emit[-1],
            "pred_references": refs,
            "indices": torch.stack(indices, dim=1),  # (B, T, Q)
        }
        logits = None
        if not self.ov:
            logits = self.class_embed(cls_in)  # (L', B, T, Q, K+1)
        if predict_masks:
            mf = mask_features
            if not self.ov:
                mf = self.mask_feature_proj(mask_features.flatten(0, 1))
                mf = mf.reshape(B, T, *mf.shape[1:])
            membd = self.mask_embed(x)
            # (L', B, Q, T, H, W) fp32
            masks = torch.einsum("lbtqc,btchw->lbqthw", membd.float(), mf.float())
            out["pred_masks"] = masks[-1]
            if training:
                out["aux_pred_masks"] = list(masks[:-1])
            if self.ov:
                # every layer's masks pool the raw mask features of its frame
                # (L' x Q masks a frame, one product)
                L = masks.shape[0]
                m = (masks > 0.0).permute(1, 3, 0, 2, 4, 5).flatten(0, 1).flatten(1, 2)
                pooled = binary_mask_pooling(mf.flatten(0, 1), m)  # (B·T, L'·Q, Cm)
                pooled = pooled.reshape(B, T, L, Q, -1).permute(2, 0, 1, 3, 4)
                logits = ov_head_logits(self, pooled, self.merge(cls_in), text_classifier,
                                        num_templates)  # (L', B, T, Q, K+1) fp32
        if logits is not None:
            out["pred_logits"] = logits[-1]
            if training:
                out["aux_pred_logits"] = list(logits[:-1])
        return out, state
