"""DVIS-DAQ meta-architectures: frozen segmenter + Video Instance Cutter
(online), and the temporal refiner over its best sequences (offline),
inference methods.

Counterpart: ``dvis_plus_tpu/models/meta/daq.py`` (``DAQOnline`` :37 with
``segment_only`` :116, ``cutter_step`` :120 and ``cutter_window`` :135;
``DAQOffline`` :196 with ``refine_embeds`` :328 and ``refine_mask_window``
:335). The JAX modules nest the parts (``segmenter`` / ``cutter``, and
``online`` / ``refiner``); here ``DAQOnline`` extends the port's
``Segmenter`` with a ``tracker`` child (the cutter, named as in the
reference checkpoints) and ``DAQOffline`` adds a ``refiner``, so the state
dict is the reference's flat key space (``backbone.*``, ``sem_seg_head.*``,
``tracker.*``, ``refiner.*``). ``cutter_window`` steps the frames of a
window in a plain loop (the JAX ``nn.scan``) and stacks their outputs on
the device. The training forwards, ``daq_train_loss`` and
``offline_topk_mask`` come with ROADMAP A14; ``mask_nms_keep`` is reached by
no path of the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from dvis_plus_tpu_torch.models.daq.cutter import CutterState, VideoInstanceCutter
from dvis_plus_tpu_torch.models.refiner.temporal_refiner import TemporalRefiner
from dvis_plus_tpu_torch.models.segmenter.segmenter import Segmenter


class DAQOnline(Segmenter):
    def __init__(self, cfg):
        """cfg: a model config (``cfg.model`` of either config kind)."""
        super().__init__(cfg)
        td, d = cfg.transformer_decoder, cfg.daq
        if td.reid_branch:
            # the JAX DAQOnline fails on it too, when it initializes its cutter
            raise ValueError(
                "model.transformer_decoder.reid_branch=True: the DAQ cutter takes the segmenter's "
                "C-wide queries, and the ReID branch makes them 2C wide; set "
                "model.transformer_decoder.reid_branch=false (the reference DVIS-DAQ segmenter "
                "has no ReID branch)")
        self.tracker = VideoInstanceCutter(
            num_classes=cfg.num_classes,
            hidden_dim=td.hidden_dim,
            feedforward_dim=cfg.tracker.feedforward_dim,
            num_heads=cfg.tracker.num_heads,
            num_layers=cfg.tracker.num_layers,
            mask_dim=td.hidden_dim,
            mask_in_dim=cfg.pixel_decoder.mask_dim,
            num_new_ins=d.num_new_ins,
            num_slots=d.num_slots,
            num_track_slots=d.max_num_instances,
            inference_select_thr=d.inference_select_thr,
            kick_out_frame_num=d.kick_out_frame_num,
            keep_threshold=d.keep_threshold,
            ovis_infer=d.ovis_infer,
        )

    def segment_only(self, images: torch.Tensor) -> Dict[str, Any]:
        """images (BT, 3, H, W) normalized -> the segmenter's per-frame outputs
        and its learned queries (``query_feat``, (fQ, C) fp32)."""
        out = super().forward(images)
        out["query_feat"] = self.sem_seg_head.predictor.query_feat.weight
        return out

    def cutter_step(self, state: CutterState, frame_embeds, mask_feature, seg_query_feat,
                    seg_pred_masks, seg_valid, first: bool = False):
        return self.tracker.inference_step(state, frame_embeds, mask_feature, seg_query_feat,
                                           seg_pred_masks, seg_valid, first=first)

    def cutter_window(self, state: CutterState, frame_embeds: torch.Tensor,
                      mask_features: torch.Tensor, seg_query_feat: torch.Tensor,
                      seg_pred_masks: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], CutterState]:
        """Steady-state steps over a window: frame_embeds (Tw, fQ, C),
        mask_features (Tw, Cm, H, W), seg_pred_masks (Tw, fQ, H, W). Returns
        the outputs stacked over the window (on the device) and the state
        after its last frame."""
        outs = []
        for t in range(frame_embeds.shape[0]):
            out, state = self.tracker.inference_step(
                state, frame_embeds[t], mask_features[t], seg_query_feat, seg_pred_masks[t], None)
            outs.append(out)
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}, state


class DAQOffline(DAQOnline):
    """DAQ online plus the temporal refiner over the ``offline_topk_num``
    best sequences; padded sequence rows are masked out of the refiner's
    object self-attention (``instance_mask``)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        td = cfg.transformer_decoder
        self.refiner = TemporalRefiner(
            num_classes=cfg.num_classes,
            hidden_dim=td.hidden_dim,
            feedforward_dim=cfg.refiner.feedforward_dim,
            num_heads=cfg.refiner.num_heads,
            num_layers=cfg.refiner.num_layers,
            mask_dim=td.hidden_dim,
        )

    def refine_embeds(self, slot_embeds: torch.Tensor, frame_embeds: torch.Tensor,
                      topk_mask: torch.Tensor):
        """slot_embeds (1, T, Qr, C), frame_embeds (1, T, fQ, C), topk_mask
        (1, Qr) False = padded row. Embeds-only refiner pass over the true
        length; pair with :meth:`refine_mask_window`."""
        return self.refiner.embed_pass(slot_embeds, frame_embeds, instance_mask=topk_mask)

    def refine_mask_window(self, mask_embed: torch.Tensor, mask_features: torch.Tensor) -> torch.Tensor:
        return self.refiner.mask_window(mask_embed, mask_features)
