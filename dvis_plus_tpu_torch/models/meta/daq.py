"""DVIS-DAQ meta-architectures: frozen segmenter + Video Instance Cutter
(online), and the temporal refiner over its best sequences (offline):
inference methods, training forwards and losses.

Counterpart: ``dvis_plus_tpu/models/meta/daq.py`` (``DAQOnline`` :37 with
its training ``__call__`` :66, ``segment_only`` :116, ``cutter_step`` :120
and ``cutter_window`` :135; ``daq_train_loss`` :172; ``DAQOffline`` :196
with its training ``__call__`` :229, ``refine_embeds`` :328 and
``refine_mask_window`` :335; ``offline_topk_mask`` :339; ``mask_nms_keep``
:351). The JAX modules
nest the parts (``segmenter`` / ``cutter``, and ``online`` / ``refiner``);
here ``DAQOnline`` extends the port's ``Segmenter`` with a ``tracker`` child
(the cutter, named as in the reference checkpoints) and ``DAQOffline`` adds
a ``refiner``, so the state dict is the reference's flat key space
(``backbone.*``, ``sem_seg_head.*``, ``tracker.*``, ``refiner.*``).
``cutter_window`` steps the frames of a window in a plain loop (the JAX
``nn.scan``) and stacks their outputs on the device.

Training takes a batch of B clips, each on its own, as the JAX step takes
its one clip (the reference trains one clip a GPU): the frozen segmenter
over the clip's frames without gradients, then the cutter (or the frozen
cutter's stream and the refiner). A clip's
draws carry the prefix ``("clip", b)``. ``mask_nms_keep`` is reached by no
path of the JAX package, nor here: it is kept for completeness.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from dvis_plus_tpu_torch.losses.targets import VideoTargets
from dvis_plus_tpu_torch.models.daq.criterion import daq_criterion
from dvis_plus_tpu_torch.models.daq.cutter import CutterState, VideoInstanceCutter, init_cutter_state
from dvis_plus_tpu_torch.models.daq.matcher import frame_match
from dvis_plus_tpu_torch.models.refiner.temporal_refiner import TemporalRefiner
from dvis_plus_tpu_torch.models.segmenter.segmenter import Segmenter
from dvis_plus_tpu_torch.utils.draws import Scoped, clip_draws


def clip_targets(targets: VideoTargets, b: int) -> VideoTargets:
    """Clip b's targets without the batch axis."""
    return VideoTargets(*(t[b] for t in targets))


def daq_train_loss(outputs: List[Dict], slot_outputs: List[Dict], targets: VideoTargets, ccfg,
                   draws, num_masks=None, slot_num_masks=None) -> Dict[str, torch.Tensor]:
    """One clip's DAQ losses: the criterion on the cutter's outputs (sites
    ``("main", ...)``) and on the slot branch's, whose targets start at
    frame 1, keyed ``slot_*`` (sites ``("slot", ...)``). ``num_masks`` and
    ``slot_num_masks`` divide each branch's mask losses (default: the
    clip's own count)."""
    T = len(outputs)
    losses = daq_criterion(outputs, targets, range(T), ccfg, Scoped(draws, ("main",)), num_masks)
    if slot_outputs:
        slot = daq_criterion(slot_outputs, targets, range(1, T), ccfg, Scoped(draws, ("slot",)),
                             slot_num_masks)
        losses.update({f"slot_{k}": v for k, v in slot.items()})
    return losses


def offline_topk_mask(mean_scores: torch.Tensor, alive: torch.Tensor, topk: int) -> torch.Tensor:
    """The ``topk`` best of the live sequences by score (S,): every live
    sequence scoring at least the k-th best live score (ties all kept)."""
    masked = torch.where(alive, mean_scores, torch.full_like(mean_scores, -1.0))
    thresh = torch.topk(masked, min(topk, masked.shape[0])).values[-1]
    return alive & (masked >= thresh)


def mask_nms_keep(masks: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                  thr: float) -> torch.Tensor:
    """Sequential mask NMS (the reference's OVIS inference): in descending
    score order (stable), a valid mask is kept unless the share of its
    pixels inside an already kept mask exceeds ``thr``. masks (S, H, W)
    logits (a pixel is on above 0), scores and valid (S,); returns keep
    (S,) bool."""
    S = masks.shape[0]
    on = (masks > 0.0).reshape(S, -1).float()
    areas = on.sum(dim=1)
    ratio = (on @ on.T) / areas.clamp(min=1.0)[:, None]  # ratio[s, t]: share of s inside t
    over = (ratio > thr).cpu()
    order = torch.argsort(-scores, stable=True).cpu().tolist()
    valid_host = valid.cpu()
    keep = torch.zeros(S, dtype=torch.bool)
    for i, s in enumerate(order):
        suppressed = any(bool(keep[t] and over[s, t]) for t in order[:i])
        keep[s] = bool(valid_host[s]) and not suppressed
    return keep.to(masks.device)


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
            training_select_thr=d.training_select_thr,
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

    def _segment_clip(self, frames: torch.Tensor) -> Dict[str, Any]:
        """One clip's frames (T, 3, H, W) -> the frozen segmenter's outputs,
        without gradients, and its learned queries."""
        with torch.no_grad():
            seg = self.segment_only(frames)
        seg["query_feat"] = seg["query_feat"].detach()
        return seg

    def train_forward(self, images: torch.Tensor, targets: VideoTargets, draws, stage: int,
                      costs) -> List[Tuple[List[Dict], List[Dict]]]:
        """The stage-2 or stage-3 training forward: images (B, T, 3, H, W)
        normalized, targets of the B clips, ``costs`` the matchers'
        (``losses.matcher.MatchCosts``). Each frame of a clip is matched to
        its ground truths on the segmenter's outputs (points from the site
        ``("frame_match", t)``), then the cutter runs the clip, every draw
        of clip b from ``utils.draws.clip_draws(draws, b)``.
        Returns (outputs, slot outputs) a clip (:meth:`VideoInstanceCutter.forward`)."""
        dev = images.device
        result = []
        for b in range(images.shape[0]):
            seg = self._segment_clip(images[b])
            tb, cd = clip_targets(targets, b), clip_draws(draws, b)
            fms = [frame_match(seg["pred_logits"][t], seg["pred_masks"][t], tb.labels,
                               tb.masks[:, t], tb.frame_valid[:, t],
                               cd.uniform(("frame_match", t), (costs.num_points, 2)).to(dev),
                               select_thr=0.01, costs=costs)
                   for t in range(images.shape[1])]
            result.append(self.tracker(seg["pred_embds_without_norm"], seg["mask_features"],
                                       seg["query_feat"], seg["pred_masks"], fms, tb, cd,
                                       stage=stage, match_costs=costs))
        return result

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

    def train_forward(self, images: torch.Tensor) -> List[Tuple[Dict, Dict]]:
        """The training forward: images (B, T, 3, H, W) normalized. The
        frozen segmenter and cutter stream each clip without gradients (the
        eval step, the first frame's queries valid above
        ``daq.aux_inference_select_thr``); each frame's slot-aligned outputs
        go to the row of their sequence id (sequences past the table's
        capacity dropped); a sequence's absent frames take its last
        similarity-guided positional embed; the refiner trains over every
        row, the rows outside the ``offline_topk_num`` best sequences (by the
        mean of their frames' logits) masked out of its object attention.
        Returns a clip's (online outputs: the sequences' mean logits (1, 1,
        S, K+1) and masks (1, S, T, H, W) -1e4 where absent; the refiner's
        training outputs)."""
        d = self.cfg.daq
        S = self.tracker.num_track_slots
        result = []
        for b in range(images.shape[0]):
            seg = self._segment_clip(images[b])
            fe, mf, pm = (seg[k] for k in ("pred_embds_without_norm", "mask_features", "pred_masks"))
            T, _, C = fe.shape
            dev = fe.device
            with torch.no_grad():
                state = init_cutter_state(S, C, fe.dtype, dev)
                embeds = torch.zeros(S + 1, T, C, dtype=fe.dtype, device=dev)
                logits = torch.zeros(S + 1, T, seg["pred_logits"].shape[-1], device=dev)
                masks = torch.full((S + 1, T, *pm.shape[-2:]), -1e4, device=dev)
                sg = torch.zeros(S + 1, C, dtype=fe.dtype, device=dev)
                tv = torch.zeros(S + 1, T, dtype=torch.bool, device=dev)
                valid0 = seg["pred_logits"][0].float().softmax(-1)[:, :-1].max(dim=1).values \
                    > d.aux_inference_select_thr
                for t in range(T):
                    out, state = self.tracker.inference_step(state, fe[t], mf[t], seg["query_feat"], pm[t],
                                                             valid0, first=t == 0)
                    sid = torch.where(out["alive"] & (out["seq_id"] < S), out["seq_id"], S)
                    embeds[sid, t] = out["slot_embeds"]
                    logits[sid, t] = out["slot_logits"].float()
                    masks[sid, t] = out["slot_masks"].float()
                    sg[sid] = out["slot_sg_pos"]
                    tv[sid, t] = True
                embeds, logits, masks, sg, tv = embeds[:S], logits[:S], masks[:S], sg[:S], tv[:S]
                cnt = tv.sum(dim=1)
                mean_logits = (logits * tv[..., None]).sum(dim=1) / cnt[:, None].clamp(min=1)
                scores = torch.where(cnt > 0, mean_logits.softmax(-1)[:, :-1].max(dim=1).values,
                                     torch.full_like(cnt, -1, dtype=torch.float32))
                inst_mask = offline_topk_mask(scores, cnt > 0, d.offline_topk_num)
                filled = torch.where(tv[..., None], embeds, sg[:, None])  # (S, T, C)
            refine_out = self.refiner(filled.transpose(0, 1)[None], fe[None], mf[None], training=True,
                                      instance_mask=inst_mask[None])
            result.append(({"pred_logits": mean_logits[None, None], "pred_masks": masks[None]},
                           refine_out))
        return result

    def refine_embeds(self, slot_embeds: torch.Tensor, frame_embeds: torch.Tensor,
                      topk_mask: torch.Tensor):
        """slot_embeds (1, T, Qr, C), frame_embeds (1, T, fQ, C), topk_mask
        (1, Qr) False = padded row. Embeds-only refiner pass over the true
        length; pair with :meth:`refine_mask_window`."""
        return self.refiner.embed_pass(slot_embeds, frame_embeds, instance_mask=topk_mask)

    def refine_mask_window(self, mask_embed: torch.Tensor, mask_features: torch.Tensor) -> torch.Tensor:
        return self.refiner.mask_window(mask_embed, mask_features)
