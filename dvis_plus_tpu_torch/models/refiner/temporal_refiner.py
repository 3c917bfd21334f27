"""Temporal refiner (DVIS++ offline stage 3).

Counterpart: ``dvis_plus_tpu/models/refiner/temporal_refiner.py``
(``TemporalConvBlock`` :47, ``TemporalRefiner._body`` :138, ``_pred_class``
:205, ``__call__`` :222, ``embed_pass`` :280, ``mask_window`` :315). Per
layer: temporal self-attention over the T frames of each (video, query),
the short-term conv block (conv1d k5 -> relu -> conv1d k3, replicate
padding, residual + LayerNorm), object self-attention over the Q queries of
each frame, cross-attention to the same frame's segmenter queries, FFN. The
class head pools the queries over time with a learned activation softmax;
the mask head is the (video, query, time) einsum against stride-4 mask
features, which the eval loop applies one window at a time
(:meth:`mask_window`) after one :meth:`embed_pass` over the whole video.

``time_mask`` (B, T), False = padded frame, supports a time axis padded by
replicating the last real frame: padded frames are excluded as keys of the
temporal attention and from the class pooling, and the conv block resets
the pad region to the last real frame before each conv. The port's eval loop
runs the true length and passes none. ``instance_mask`` (B, Q), False =
padded query row (the DAQ offline pass pads its sequences to a fixed count),
excludes those rows as keys of the object self-attention
(``_body`` :142-170).

Parameter names follow the reference ``dvis_Plus/refiner.py``
(``transformer_time_self_attention_layers``,
``transformer_obj_self_attention_layers``,
``transformer_cross_attention_layers``, ``transformer_ffn_layers``,
``conv_short_aggregate_layers.{i}.{0,2}``, ``conv_norms``,
``decoder_norm``, ``mask_embed``, ``activation_proj``, ``class_embed``).
``ov=True`` is the open-vocabulary refiner (:94-126, :247-262, ``ov_classify``
:299-340; the reference ``TemporalRefiner_OV``): the class head is the
FC-CLIP one (``models/ov/ov_decoder.py::add_ov_head``), fed the mask
features pooled under the video's masks plus the time-pooled query;
:meth:`embed_pass` then returns the time-pooled query (``fused``) for
:meth:`ov_classify`, which the eval loop calls with features it pooled
window by window. Not ported: the object-sharded pass (ROADMAP). Every
layer computes in its input's dtype.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dvis_plus_tpu_torch.models.layers import Conv1d, LayerNorm, Linear
from dvis_plus_tpu_torch.models.ov.ov_decoder import add_ov_head, ov_head_logits
from dvis_plus_tpu_torch.models.segmenter.transformer_decoder import (
    MLP,
    CrossAttentionLayer,
    FFNLayer,
    SelfAttentionLayer,
)

_NEG_INF = -1e9


def _edge_pad(y: torch.Tensor, n: int) -> torch.Tensor:
    """Replicate-pad the last (time) axis by ``n`` on both sides."""
    return torch.cat([y[..., :1].expand(*y.shape[:-1], n), y,
                      y[..., -1:].expand(*y.shape[:-1], n)], dim=-1)


class TemporalRefiner(nn.Module):
    def __init__(self, num_classes: int, hidden_dim: int = 256, feedforward_dim: int = 2048,
                 num_heads: int = 8, num_layers: int = 6, mask_dim: int = 256, ov: bool = False,
                 clip_embed_dim: int = 768):
        super().__init__()
        C = hidden_dim
        self.num_layers = num_layers
        self.transformer_time_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(C, num_heads) for _ in range(num_layers)
        )
        self.conv_short_aggregate_layers = nn.ModuleList(
            nn.Sequential(Conv1d(C, C, 5), nn.ReLU(), Conv1d(C, C, 3))
            for _ in range(num_layers)
        )
        self.conv_norms = nn.ModuleList(LayerNorm(C, eps=1e-5) for _ in range(num_layers))
        self.transformer_obj_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(C, num_heads) for _ in range(num_layers)
        )
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(C, num_heads) for _ in range(num_layers)
        )
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(C, feedforward_dim) for _ in range(num_layers)
        )
        self.decoder_norm = LayerNorm(C, eps=1e-5)
        self.mask_embed = MLP(C, C, mask_dim, 3)
        self.activation_proj = Linear(C, 1)
        self.ov = ov
        if ov:
            add_ov_head(self, mask_dim, C, clip_embed_dim)
        else:
            self.class_embed = Linear(C, num_classes + 1)

    def _conv_block(self, i: int, x: torch.Tensor, time_ok: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B', T, C); time_ok (B', T) or None."""
        if time_ok is not None:
            last = (time_ok.sum(dim=1) - 1).long()  # (B',)

            def fix(z):  # (B', C, T): pad frames take the last real frame's values
                idx = last[:, None, None].expand(z.shape[0], z.shape[1], 1)
                return torch.where(time_ok[:, None, :], z, z.gather(2, idx))
        else:
            fix = lambda z: z  # noqa: E731

        conv1, _, conv2 = self.conv_short_aggregate_layers[i]
        y = fix(x.transpose(1, 2))  # (B', C, T)
        y = F.relu(conv1(_edge_pad(y, 2)))
        y = conv2(_edge_pad(fix(y), 1))
        return self.conv_norms[i](x + y.transpose(1, 2))

    def _body(self, instance_embeds: torch.Tensor, frame_embeds: torch.Tensor,
              time_mask: Optional[torch.Tensor] = None,
              instance_mask: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """instance_embeds (B, T, Q, C), frame_embeds (B, T, fQ, C) ->
        every layer's output (B, T, Q, C), the last one last."""
        B, T, Q, C = instance_embeds.shape
        obj_bias = None
        if instance_mask is not None:
            key_ok = instance_mask.repeat_interleave(T, dim=0)  # (B*T, Q)
            obj_bias = torch.zeros(key_ok.shape, dtype=torch.float32, device=key_ok.device)
            obj_bias = obj_bias.masked_fill(~key_ok, _NEG_INF)[:, None, None, :]
        tmask_bias = key_ok_t = None
        if time_mask is not None:
            key_ok_t = time_mask.repeat_interleave(Q, dim=0)  # (B*Q, T)
            tmask_bias = torch.zeros(key_ok_t.shape, dtype=torch.float32, device=key_ok_t.device)
            tmask_bias = tmask_bias.masked_fill(~key_ok_t, _NEG_INF)[:, None, None, :]
        mem = frame_embeds.reshape(B * T, frame_embeds.shape[2], C)
        output = instance_embeds
        outputs = []
        for i in range(self.num_layers):
            x = output.transpose(1, 2).reshape(B * Q, T, C)
            x = self.transformer_time_self_attention_layers[i](x, mask=tmask_bias)
            x = self._conv_block(i, x, key_ok_t)
            x = x.reshape(B, Q, T, C).transpose(1, 2).reshape(B * T, Q, C)
            x = self.transformer_obj_self_attention_layers[i](x, mask=obj_bias)
            x = self.transformer_cross_attention_layers[i](x, mem, 0.0, 0.0)
            x = self.transformer_ffn_layers[i](x)
            output = x.reshape(B, T, Q, C)
            outputs.append(output)
        return outputs

    def _pred_class(self, x: torch.Tensor, time_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Activation-weighted temporal pooling. x normalized (B, T, Q, C) ->
        (B, 1, Q, C); padded frames are excluded from the softmax."""
        a = self.activation_proj(x)  # (B, T, Q, 1)
        if time_mask is not None:
            a = a.masked_fill(~time_mask[:, :, None, None], _NEG_INF)
        return (x * a.softmax(dim=1)).sum(dim=1, keepdim=True)

    def forward(self, instance_embeds: torch.Tensor, frame_embeds: torch.Tensor,
                mask_features: torch.Tensor, text_classifier: Optional[torch.Tensor] = None,
                num_templates: Optional[Sequence[int]] = None,
                training: bool = False,
                instance_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Whole-video forward: instance_embeds (B, T, Q, C), frame_embeds
        (B, T, fQ, C), mask_features (B, T, mask_dim, H, W); with ``ov`` the
        text classifier (R, Cc) and ``num_templates``. ``training``: also
        every earlier layer's logits and masks, ``aux_pred_logits`` /
        ``aux_pred_masks``, for the deep supervision (the JAX module emits
        every layer then, :227-237; not with ``ov``). ``instance_mask`` (B, Q)
        False: a padded row, which no object attends to."""
        layers = self._body(instance_embeds, frame_embeds, instance_mask=instance_mask)
        if training:
            if self.ov:
                raise NotImplementedError("training the open-vocabulary refiner is ROADMAP A14c.5")
            aux = [self._layer_predictions(self.decoder_norm(y), mask_features)
                   for y in layers[:-1]]
            out = self._layer_predictions(self.decoder_norm(layers[-1]), mask_features)
            out["aux_pred_logits"] = [a["pred_logits"] for a in aux]
            out["aux_pred_masks"] = [a["pred_masks"] for a in aux]
            return out
        x = self.decoder_norm(layers[-1])
        if not self.ov:
            return self._layer_predictions(x, mask_features)
        fused = self._pred_class(x)
        masks = self.mask_window(self.mask_embed(x), mask_features)  # (B, Q, T, H, W)
        # the video's binary masks pool the mask features (fp32 sums)
        m = (masks > 0.0).float()
        pooled = torch.einsum("bqthw,btchw->bqc", m, mask_features.float())
        pooled = pooled / (m.sum(dim=(-1, -2, -3))[..., None] + 1e-8)
        logits = self.ov_classify(fused, pooled.to(x.dtype), text_classifier, num_templates)
        logits = logits[:, None].expand(*x.shape[:3], logits.shape[-1])
        return {"pred_logits": logits, "pred_masks": masks, "pred_embds": x}

    def _layer_predictions(self, x: torch.Tensor, mask_features: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One layer's normed output x (B, T, Q, C) -> its time-pooled class
        logits, duplicated over the frames (B, T, Q, K+1), and its masks
        (B, Q, T, H, W)."""
        logits = self.class_embed(self._pred_class(x).expand(x.shape))
        return {"pred_logits": logits, "pred_masks": self.mask_window(self.mask_embed(x), mask_features),
                "pred_embds": x}

    def embed_pass(self, instance_embeds: torch.Tensor, frame_embeds: torch.Tensor,
                   time_mask: Optional[torch.Tensor] = None,
                   instance_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Embeds only: video-level class logits (B, Q, K+1) (with ``ov``
        instead the time-pooled query ``fused`` (B, 1, Q, C) for
        :meth:`ov_classify`) and the mask-head embeddings (B, T, Q, mask_dim)
        for :meth:`mask_window`."""
        x = self.decoder_norm(self._body(instance_embeds, frame_embeds, time_mask, instance_mask)[-1])
        fused = self._pred_class(x, time_mask)
        out = {"mask_embed": self.mask_embed(x), "pred_embds": x}
        if self.ov:
            out["fused"] = fused
        else:
            out["pred_logits"] = self.class_embed(fused)[:, 0]
        return out

    def ov_classify(self, fused: torch.Tensor, pooled: torch.Tensor,
                    text_classifier: torch.Tensor, num_templates: Sequence[int]) -> torch.Tensor:
        """Video-level open-vocabulary logits (B, Q, K+1) fp32 from ``fused``
        (B, 1, Q, C) and the mask features pooled under the video's masks
        (B, Q, mask_dim)."""
        return ov_head_logits(self, pooled[:, None], fused, text_classifier, num_templates)[:, 0]

    def mask_window(self, mask_embed: torch.Tensor, mask_features: torch.Tensor) -> torch.Tensor:
        """Mask head on one time window: mask_embed (B, Tw, Q, Cm),
        mask_features (B, Tw, Cm, H, W) -> (B, Q, Tw, H, W) fp32 logits."""
        return torch.einsum("btqc,btchw->bqthw", mask_embed.float(), mask_features.float())
