"""DVIS++ online meta-architecture: frozen segmenter + referring tracker.

Counterpart: ``dvis_plus_tpu/models/meta/dvis_online.py`` (``DVISOnline``
:40 with its training forward :62-88, ``reorder_image_outputs`` :91,
``dvis_online_train_loss`` :104, ``online_post_processing`` :180,
``inference_video_vis`` :192, and the
VSS and VPS heads ``semantic_inference`` :206, ``panoptic_probs`` :229,
``panoptic_segments_host`` :260). The module holds its weights under the
reference checkpoints' names (``backbone.*``, ``sem_seg_head.*``,
``tracker.*``); the embedding width doubles with the ReID branch.

The VPS heads keep the whole video's segment bookkeeping on the device
(:func:`panoptic_chunk_counts`, :func:`panoptic_segment_table`,
:func:`panoptic_segments_device`): the JAX eval loop moves the (Q, T, H, W)
upsampled masks to the host as fp16 and walks them once per kept query; here
only three per-query counts and the (T, H, W) id map leave the card, with
the same result (:func:`panoptic_segments_host` is the plain version).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dvis_plus_tpu_torch.models.meta.minvis import topk_select, upsample_masks
from dvis_plus_tpu_torch.models.segmenter.segmenter import Segmenter
from dvis_plus_tpu_torch.models.tracker.referring_tracker import ReferringTracker, TrackerState
from dvis_plus_tpu_torch.parallel.mesh import global_sum


class DVISOnline(Segmenter):
    def __init__(self, cfg):
        """cfg: a model config (``cfg.model`` of either config kind)."""
        super().__init__(cfg)
        td = cfg.transformer_decoder
        self.tracker = ReferringTracker(
            num_classes=cfg.num_classes,
            hidden_dim=td.hidden_dim * (2 if td.reid_branch else 1),
            feedforward_dim=cfg.tracker.feedforward_dim,
            num_heads=cfg.tracker.num_heads,
            num_layers=cfg.tracker.num_layers,
            mask_dim=td.hidden_dim,
            mask_in_dim=cfg.pixel_decoder.mask_dim,
            matcher=cfg.tracker.matcher_solver,
            noise_ratio=cfg.tracker.noise_ratio,
            noise_mode=cfg.tracker.noise_mode,
        )

    def forward(
        self,
        images: torch.Tensor,  # (B, T, 3, H, W) normalized
        state: Optional[TrackerState] = None,
        predict_masks: bool = True,
    ) -> Tuple[Dict[str, Any], Dict[str, Any], TrackerState]:
        B, T = images.shape[:2]
        seg_out = super().forward(images.flatten(0, 1))
        C2 = seg_out["pred_embds"].shape[-1]
        mf = seg_out["mask_features"]
        track_out, new_state = self.tracker(
            seg_out["pred_embds"].reshape(B, T, -1, C2),
            mf.reshape(B, T, *mf.shape[1:]),
            frame_embeds_no_norm=seg_out["pred_embds_without_norm"].reshape(B, T, -1, C2),
            state=state,
            predict_masks=predict_masks,
        )
        return seg_out, track_out, new_state


    def train_forward(self, images: torch.Tensor, draws) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """The training forward (``DVISOnline.__call__`` with ``training``,
        :62-88): the frozen segmenter without gradients (the JAX module's
        ``stop_gradient``, the reference's ``torch.no_grad``), then the
        tracker with its noise from ``draws`` and every layer's outputs.
        images (B, T, 3, H, W) normalized. Returns (seg_out, track_out)."""
        B, T = images.shape[:2]
        with torch.no_grad():
            seg_out = Segmenter.forward(self, images.flatten(0, 1))
        C2 = seg_out["pred_embds"].shape[-1]
        mf = seg_out["mask_features"]
        track_out, _ = self.tracker(
            seg_out["pred_embds"].reshape(B, T, -1, C2),
            mf.reshape(B, T, *mf.shape[1:]),
            frame_embeds_no_norm=seg_out["pred_embds_without_norm"].reshape(B, T, -1, C2),
            draws=draws,
        )
        return seg_out, track_out


def reorder_image_outputs(seg_logits: torch.Tensor, seg_masks: torch.Tensor,
                          indices: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The segmenter's predictions in the tracker's slot order
    (``reorder_image_outputs`` :91, the reference's
    ``reset_image_output_order``): seg_logits (B, T, Q, K+1), seg_masks (B, Q,
    T, H, W), indices (B, T, Q) slot -> query."""
    logits = torch.gather(seg_logits, 2, indices[..., None].expand_as(seg_logits))
    masks_t = seg_masks.transpose(1, 2)  # (B, T, Q, H, W)
    masks_t = torch.gather(masks_t, 2, indices[..., None, None].expand_as(masks_t))
    return logits, masks_t.transpose(1, 2)


def dvis_online_train_loss(seg_out: Dict[str, Any], track_out: Dict[str, Any], targets,
                           ccfg, use_matcher_guidance: bool, draws) -> Dict[str, torch.Tensor]:
    """The online stage's losses (``dvis_online_train_loss`` :104-177):
    consistent (first-appearance) matching; while ``use_matcher_guidance``
    (the first half of training) the segmenter's reordered predictions drive
    one assignment for every layer, after it each layer is matched on its
    own outputs; ``num_masks`` = instances x T (the reference counts an
    instance once a frame); the ReID loss at weights 2 and 3. The final
    layer's matching draws its points once (site ``("match", "final")``),
    for the guided and the self matching alike, as the JAX function uses
    one key for both."""
    from dvis_plus_tpu_torch.losses.criterion import LayerOutputs, layer_losses, match, match_coords
    from dvis_plus_tpu_torch.losses.reid import reid_loss

    B, N, T = targets.masks.shape[:3]
    ccfg = ccfg._replace(match_mode="frame_consistent")
    num_masks = global_sum(targets.num_instances().sum().float() * T).clamp(min=1.0)
    outputs = LayerOutputs(track_out["pred_logits"], track_out["pred_masks"])
    aux = [LayerOutputs(lg, mk) for lg, mk in zip(track_out["aux_pred_logits"],
                                                 track_out["aux_pred_masks"])]
    coords = match_coords(draws, "final", outputs, ccfg)
    if use_matcher_guidance:
        Q = outputs.pred_logits.shape[2]
        seg_masks = seg_out["pred_masks"]
        seg_masks = seg_masks.reshape(B, T, Q, *seg_masks.shape[-2:]).transpose(1, 2)
        g_logits, g_masks = reorder_image_outputs(
            seg_out["pred_logits"].reshape(B, T, Q, -1), seg_masks, track_out["indices"])
        q4g = match(LayerOutputs(g_logits, g_masks), targets, ccfg, coords)
    else:
        q4g = match(outputs, targets, ccfg, coords)
    losses = layer_losses(outputs, targets, q4g, num_masks, ccfg, draws, "final")
    for i, a in enumerate(aux):
        q4g_aux = q4g if use_matcher_guidance else match(a, targets, ccfg,
                                                         match_coords(draws, i, a, ccfg))
        losses.update(layer_losses(a, targets, q4g_aux, num_masks, ccfg, draws, i, f"_{i}"))
    cl = reid_loss(track_out["pred_references"], q4g, targets.valid)
    losses["loss_reid"] = 2.0 * cl["loss_reid"]
    losses["loss_aux_reid"] = 3.0 * cl["loss_aux_reid"]
    return losses


def online_post_processing(pred_logits: torch.Tensor) -> torch.Tensor:
    """(T, Q, K+1) -> mean class logits over frames; ids are arange(Q)."""
    return pred_logits.mean(dim=0)


def inference_video_vis(mask_cls, mask_pred, img_size, output_size, padded_size, topk=20):
    """One-shot top-K VIS extraction: (scores, labels, (topk, T, out_h, out_w)
    bool masks). The eval loop pages the upsampling instead
    (``engine.inference.paged_inference_video``)."""
    scores, labels, queries = topk_select(mask_cls, topk)
    return scores, labels, upsample_masks(mask_pred[queries], img_size, output_size, padded_size)


# ---------------------------------------------------------------------------
# VSS and VPS heads
# ---------------------------------------------------------------------------


def _class_probs(mask_cls: torch.Tensor, aux_pred_cls: Optional[torch.Tensor]) -> torch.Tensor:
    """(Q, K+1) softmax; with ``aux_pred_cls`` its first K columns take the
    element-wise max with the aux softmax's (no renormalization)."""
    probs = mask_cls.float().softmax(-1)
    if aux_pred_cls is None:
        return probs
    aux = aux_pred_cls.float().softmax(-1)[:, :-1]
    return torch.cat([torch.maximum(probs[:, :-1], aux), probs[:, -1:]], dim=-1)


def mask_probs(
    mask_pred: torch.Tensor,  # (Q, t, H4, W4) mask logits
    img_size: Tuple[int, int],
    output_size: Tuple[int, int],
    padded_size: Tuple[int, int],
) -> torch.Tensor:
    """(Q, t, out_h, out_w) fp32 mask probabilities: resize the logits to the
    padded model input, crop the valid region, sigmoid, then resize the
    probabilities to the output size. The second resize has
    ``antialias=True``: ``jax.image.resize``'s filter where it downsamples
    (VSPW's 480p output of a 720p input), plain bilinear where it upsamples
    (see ``minvis.upsample_masks``, which thresholds logits instead)."""
    masks = F.interpolate(mask_pred.float(), size=tuple(padded_size), mode="bilinear", align_corners=False)
    masks = masks[:, :, : img_size[0], : img_size[1]].sigmoid()
    return F.interpolate(masks, size=tuple(output_size), mode="bilinear", align_corners=False,
                         antialias=True)


def semantic_inference(
    mask_cls: torch.Tensor,  # (Q, K+1)
    mask_pred: torch.Tensor,  # (Q, t, H4, W4)
    img_size: Tuple[int, int],
    output_size: Tuple[int, int],
    padded_size: Tuple[int, int],
    aux_pred_cls: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """VSS class map (t, out_h, out_w) int64: per pixel the argmax over
    classes of ``einsum("qc,qthw->cthw", probs, masks)``, with the no-object
    column dropped before the aux max. The (K, H, W) product is formed one
    frame at a time, so that a (K, t, H, W) tensor is never the peak."""
    probs = _class_probs(mask_cls, aux_pred_cls)[:, :-1]
    masks = mask_probs(mask_pred, img_size, output_size, padded_size)
    return torch.stack([torch.einsum("qc,qhw->chw", probs, masks[:, t]).argmax(0)
                        for t in range(masks.shape[1])])


def panoptic_scores(mask_cls: torch.Tensor, object_mask_threshold: float,
                    aux_pred_cls: Optional[torch.Tensor] = None):
    """Per query (scores, labels, keep), each (Q,), from the full K+1 softmax
    (aux fused into its first K columns): keep = label is not the no-object
    class and score > ``object_mask_threshold``."""
    probs = _class_probs(mask_cls, aux_pred_cls)
    scores, labels = probs.amax(-1), probs.argmax(-1)
    keep = (labels != mask_cls.shape[-1] - 1) & (scores > object_mask_threshold)
    return scores, labels, keep


def panoptic_probs(
    mask_cls: torch.Tensor,  # (Q, K+1)
    mask_pred: torch.Tensor,  # (Q, t, H4, W4)
    img_size: Tuple[int, int],
    output_size: Tuple[int, int],
    padded_size: Tuple[int, int],
    object_mask_threshold: float,
    aux_pred_cls: Optional[torch.Tensor] = None,
):
    """Device part of VPS inference: (scores, labels, keep) per query, the
    (Q, t, out_h, out_w) fp32 mask probabilities and the (t, out_h, out_w)
    per-pixel argmax query of ``scores * masks`` over the kept queries (all
    zeros, so query 0, where none is kept)."""
    scores, labels, keep = panoptic_scores(mask_cls, object_mask_threshold, aux_pred_cls)
    masks = mask_probs(mask_pred, img_size, output_size, padded_size)
    weight = torch.where(keep, scores, torch.zeros_like(scores))[:, None, None, None]
    mask_ids = (weight * masks).argmax(0)
    return scores, labels, keep, masks, mask_ids


def panoptic_segments_host(
    scores: np.ndarray,
    labels: np.ndarray,
    keep: np.ndarray,
    masks: np.ndarray,  # (Q, T, H, W) sigmoid probs, fp16 as the JAX eval loop stores them
    mask_ids: np.ndarray,  # (T, H, W)
    num_thing_classes: int,
    overlap_threshold: float,
):
    """Plain host-side segment bookkeeping (the JAX package's, in numpy):
    stable segment ids, stuff merged by class, overlap filtering. Returns
    (panoptic_seg (T, H, W) int32, segments_infos, kept query indices)."""
    T, H, W = mask_ids.shape
    panoptic_seg = np.zeros((T, H, W), np.int32)
    segments_infos = []
    out_ids = []
    current_segment_id = 0
    stuff_memory: Dict[int, int] = {}
    for k in range(labels.shape[0]):
        if not keep[k]:
            continue
        pred_class = int(labels[k])
        isthing = pred_class < num_thing_classes
        mask_area = int((mask_ids == k).sum())
        original_area = int((masks[k] >= 0.5).sum())
        mask = (mask_ids == k) & (masks[k] >= 0.5)
        if mask_area > 0 and original_area > 0 and mask.sum() > 0:
            if mask_area / original_area < overlap_threshold:
                continue
            if not isthing:
                if pred_class in stuff_memory:
                    panoptic_seg[mask] = stuff_memory[pred_class]
                    continue
                stuff_memory[pred_class] = current_segment_id + 1
            current_segment_id += 1
            panoptic_seg[mask] = current_segment_id
            segments_infos.append(
                {"id": current_segment_id, "isthing": bool(isthing), "category_id": pred_class}
            )
            out_ids.append(k)
    return panoptic_seg, segments_infos, out_ids


def panoptic_chunk_counts(masks: torch.Tensor, mask_ids: torch.Tensor):
    """One chunk's share of the segment bookkeeping, on the masks' device.
    Returns ((3, Q) int64 counts: ``mask_area`` = #(ids == k),
    ``original_area`` = #(mask_k >= 0.5), ``overlap`` = #(ids == k and
    mask_k >= 0.5); the (t, H, W) bool flag "own mask >= 0.5"). The masks
    are thresholded after rounding to fp16, as the JAX eval loop stores
    them: a probability from 0.5 - 2^-13 up counts as inside."""
    Q = masks.shape[0]
    inside = masks.half() >= 0.5  # (Q, t, H, W)
    ids = mask_ids.reshape(-1)
    own = inside.gather(0, mask_ids[None])[0]
    counts = torch.zeros(3, Q, dtype=torch.int64, device=masks.device)
    counts[0].scatter_add_(0, ids, torch.ones_like(ids))
    counts[1] = inside.reshape(Q, -1).sum(1)
    counts[2].scatter_add_(0, ids, own.reshape(-1).long())
    return counts, own


def panoptic_segment_table(scores, labels, keep, counts, num_thing_classes: int,
                           overlap_threshold: float):
    """The host loop of :func:`panoptic_segments_host` on the counts of
    :func:`panoptic_chunk_counts` (numpy, summed over the video): (table
    (Q,) int32: the segment id each query's pixels take, 0 for none;
    segments_infos; kept query indices)."""
    table = np.zeros(len(labels), np.int32)
    segments_infos = []
    out_ids = []
    current_segment_id = 0
    stuff_memory: Dict[int, int] = {}
    for k in range(len(labels)):
        if not keep[k]:
            continue
        pred_class = int(labels[k])
        isthing = pred_class < num_thing_classes
        mask_area, original_area, overlap = (int(c) for c in counts[:, k])
        if mask_area > 0 and original_area > 0 and overlap > 0:
            if mask_area / original_area < overlap_threshold:
                continue
            if not isthing:
                if pred_class in stuff_memory:
                    table[k] = stuff_memory[pred_class]
                    continue
                stuff_memory[pred_class] = current_segment_id + 1
            current_segment_id += 1
            table[k] = current_segment_id
            segments_infos.append(
                {"id": current_segment_id, "isthing": bool(isthing), "category_id": pred_class}
            )
            out_ids.append(k)
    return table, segments_infos, out_ids


def panoptic_segments_device(
    scores: torch.Tensor,
    labels: torch.Tensor,
    keep: torch.Tensor,
    chunks: Iterable[Tuple[torch.Tensor, torch.Tensor]],  # (masks (Q, t, H, W), mask_ids (t, H, W))
    num_thing_classes: int,
    overlap_threshold: float,
    timings: Optional[dict] = None,
):
    """:func:`panoptic_segments_host` with the masks kept on their device:
    each chunk adds its counts and keeps its int16 ids and own-mask flags
    (3 bytes a pixel), one (3, Q) download feeds the host loop, and the id
    map is ``table[ids]`` where the flag is set, 0 elsewhere (the queries'
    pixels are disjoint, so this equals the sequential writes). Returns
    (panoptic_seg (T, H, W) int32 on the device, segments_infos, kept query
    indices). ``timings["segments_s"]`` accumulates the host loop's wall
    time."""
    counts, ids_l, own_l = None, [], []
    for masks, mask_ids in chunks:
        c, own = panoptic_chunk_counts(masks, mask_ids)
        counts = c if counts is None else counts + c
        ids_l.append(mask_ids.to(torch.int16))
        own_l.append(own)
        del masks, mask_ids  # one chunk's probabilities alive at a time, not two
    counts = counts.cpu().numpy()
    t0 = time.perf_counter()
    table, segments_infos, out_ids = panoptic_segment_table(
        scores.cpu().numpy(), labels.cpu().numpy(), keep.cpu().numpy(), counts,
        num_thing_classes, overlap_threshold)
    if timings is not None:
        timings["segments_s"] = timings.get("segments_s", 0.0) + time.perf_counter() - t0
    ids, own = torch.cat(ids_l), torch.cat(own_l)
    table = torch.from_numpy(table).to(ids.device)
    panoptic_seg = torch.where(own, table[ids.long()], torch.zeros((), dtype=torch.int32, device=ids.device))
    return panoptic_seg, segments_infos, out_ids
