"""Clip-joint masked-attention decoder (the Video Mask2Former query decoder).

Counterpart: ``dvis_plus_tpu/models/segmenter/clip_decoder.py::
ClipMaskedTransformerDecoder`` (:28-116). One query set decodes the whole
clip: a level's cross-attention memory is its (T·H_l·W_l) token stack with
the 3D (t, y, x) sine position encoding, the class logits are clip-level
(B, Q, K+1) and the masks (B, Q, T, H4, W4). The layers, their parameter
names and the reference key space are those of
:class:`~dvis_plus_tpu_torch.models.segmenter.transformer_decoder.MaskedTransformerDecoder`
without the ReID branch (reference ``VideoMultiScaleMaskedTransformerDecoder``).

The next layer's attention mask is the mask logits resized over (T, h, w):
T keeps its size, so it is a plain half-pixel bilinear resize of each
frame, not antialiased (``jax.image.resize(..., antialias=False)``), blocked
where ``sigmoid < 0.5`` with all-blocked rows unblocked, as in the per-frame
decoder. With ``aux`` it also returns every earlier prediction
(``aux_pred_logits`` / ``aux_pred_masks``: the queries' first prediction and
each layer's but the last), which training supervises.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from dvis_plus_tpu_torch.models.segmenter.position_encoding import position_embedding_sine_3d
from dvis_plus_tpu_torch.models.segmenter.transformer_decoder import (
    _NEG_INF,
    MaskedTransformerDecoder,
)


class ClipMaskedTransformerDecoder(MaskedTransformerDecoder):
    """Built with the per-frame decoder's arguments (``reid_branch`` off)."""

    def _clip_heads(self, output, mask_features, attn_size):
        """mask_features (B, T, Cm, H4, W4) -> clip logits (B, Q, K+1), masks
        (B, Q, T, H4, W4) fp32 and the additive mask (B, 1, Q, T·h·w)."""
        x = self.decoder_norm(output)
        logits = self.class_embed(x)
        memb = self.mask_embed(x)
        masks = torch.einsum("bqc,btchw->bqthw", memb.float(), mask_features.float())
        B, Q = masks.shape[:2]
        am = F.interpolate(masks.flatten(1, 2), size=attn_size, mode="bilinear", align_corners=False)
        blocked = am.reshape(B, Q, -1).sigmoid() < 0.5
        blocked = blocked & ~blocked.all(dim=-1, keepdim=True)
        additive = torch.zeros(blocked.shape, dtype=torch.float32, device=blocked.device)
        return logits, masks, additive.masked_fill(blocked, _NEG_INF)[:, None]

    def forward(self, multi_scale: Sequence[torch.Tensor], mask_features: torch.Tensor,
                num_frames: int, aux: bool = False) -> Dict[str, torch.Tensor]:
        """multi_scale: 3 x (B·T, C, H_l, W_l), strides 32, 16, 8;
        mask_features: (B·T, mask_dim, H4, W4)."""
        T = num_frames
        B = multi_scale[0].shape[0] // T
        C = self.hidden_dim
        dtype = multi_scale[0].dtype
        srcs, poss, sizes = [], [], []
        for i, x in enumerate(multi_scale):
            Hl, Wl = x.shape[-2:]
            tokens = self.input_proj[i](x).flatten(2).transpose(1, 2).reshape(B, T * Hl * Wl, C)
            srcs.append(tokens + self.level_embed.weight[i].to(dtype)[None, None])
            pe = position_embedding_sine_3d(T, Hl, Wl, C, device=x.device)
            poss.append(pe.reshape(1, T * Hl * Wl, C).to(dtype))
            sizes.append((Hl, Wl))
        mf = mask_features.reshape(B, T, *mask_features.shape[1:])

        output = self.query_feat.weight[None].expand(B, -1, -1).to(dtype)
        qpos = self.query_embed.weight[None].expand(B, -1, -1).to(dtype)
        logits, masks, attn_mask = self._clip_heads(output, mf, sizes[0])
        aux_logits, aux_masks = [], []
        for i in range(self.num_layers):
            if aux:
                aux_logits.append(logits)
                aux_masks.append(masks)
            li = i % self.num_levels
            output = self.transformer_cross_attention_layers[i](
                output, srcs[li], poss[li], qpos, attn_mask
            )
            output = self.transformer_self_attention_layers[i](output, qpos)
            output = self.transformer_ffn_layers[i](output)
            logits, masks, attn_mask = self._clip_heads(
                output, mf, sizes[(i + 1) % self.num_levels]
            )
        out = {
            "pred_logits": logits,  # (B, Q, K+1)
            "pred_masks": masks,  # (B, Q, T, H4, W4)
            "pred_embds": self.decoder_norm(output),
        }
        if aux:
            out["aux_pred_logits"], out["aux_pred_masks"] = aux_logits, aux_masks
        return out
