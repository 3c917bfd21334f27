"""MinVIS training and inference (query alignment across frames by
embedding matching), and the video post-processing shared by the VIS heads:
flat top-K and two-stage mask upsampling.

Counterpart: ``dvis_plus_tpu/models/meta/minvis.py`` (``frame_fold_targets``
:31, ``minvis_train_loss`` :45, ``match_from_embds`` :71,
``minvis_alignment`` :94, ``minvis_post_processing`` :132, ``topk_select``
:157, ``upsample_masks`` :178, ``inference_video`` :199). MinVIS and CTVIS
train the bare segmenter on frames folded into the batch: every frame is a
clip of one frame for the matcher and the losses, and every instance of the
clip (present in the frame or not) is a candidate there.
MinVIS and CTVIS run the bare segmenter per frame; each frame's queries are
then matched to the previous frame's aligned queries on the cosine cost of
their embeddings, and the class logits are averaged over frames. The JAX
alignment is a ``lax.scan``; here it is a loop carrying the previous frame's
aligned embeddings, with the solver on the cost's device (``auction``) or on
the host (``jv``, scipy).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dvis_plus_tpu_torch.losses.criterion import CriterionConfig, LayerOutputs, video_criterion
from dvis_plus_tpu_torch.losses.targets import VideoTargets
from dvis_plus_tpu_torch.ops.assignment import auction_lap
from dvis_plus_tpu_torch.ops.hungarian import hungarian
from dvis_plus_tpu_torch.parallel.mesh import global_sum


def frame_fold_targets(targets: VideoTargets) -> VideoTargets:
    """(B, N, T, ...) clip targets -> (B*T, N, 1, ...) per-frame targets;
    labels and ``valid`` stay clip-level (an absent instance matches with an
    empty mask)."""
    B, N, T = targets.frame_valid.shape
    masks = targets.masks.transpose(1, 2).reshape(B * T, N, 1, *targets.masks.shape[-2:])
    return VideoTargets(labels=targets.labels.repeat_interleave(T, dim=0), masks=masks,
                        valid=targets.valid.repeat_interleave(T, dim=0),
                        frame_valid=targets.frame_valid.transpose(1, 2).reshape(B * T, N, 1))


def minvis_train_loss(decoder_out: Dict[str, Any], targets: VideoTargets, ccfg: CriterionConfig,
                      draws) -> Dict[str, torch.Tensor]:
    """The per-frame losses of the segmenter's outputs (``decoder_out``, its
    tensors leading with B*T, with the auxiliary predictions): one
    clip-level matching a frame and the criterion over every layer,
    ``num_masks`` the instances a frame summed over the frames."""
    ft = frame_fold_targets(targets)
    num_masks = global_sum(ft.num_instances().sum().float()).clamp(min=1.0)
    outputs = LayerOutputs(decoder_out["pred_logits"], decoder_out["pred_masks"][:, :, None])
    aux = [LayerOutputs(lg, mk[:, :, None])
           for lg, mk in zip(decoder_out["aux_pred_logits"], decoder_out["aux_pred_masks"])]
    losses, _ = video_criterion(outputs, aux, ft, ccfg, draws, num_masks=num_masks)
    return losses


def match_from_embds(tgt_embds: torch.Tensor, cur_embds: torch.Tensor,
                     solver: str = "jv") -> torch.Tensor:
    """(Q, C) target and current embeddings -> indices such that
    ``cur[indices]`` aligns with ``tgt``: the minimum-cost assignment on
    1 - cosine similarity (norms offset by 1e-12, not the tracker's 1e-6).
    ``jv`` is exact (scipy); ``auction`` is the approximate solver, which may
    pick another permutation on near-degenerate costs."""
    cur = cur_embds / (cur_embds.norm(dim=1, keepdim=True) + 1e-12)
    tgt = tgt_embds / (tgt_embds.norm(dim=1, keepdim=True) + 1e-12)
    cost = 1.0 - tgt @ cur.T  # (Q_tgt, Q_cur)
    if solver == "auction":
        return auction_lap(cost)
    return hungarian(cost)[0]


def minvis_alignment(
    pred_logits: torch.Tensor,  # (T, Q, K+1)
    pred_embds: torch.Tensor,  # (T, Q, C)
    valid: Optional[torch.Tensor] = None,  # (T,) bool; False = padded frame
    solver: str = "jv",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-by-frame alignment without the masks: (mean logits (Q, K+1) over
    the ``valid`` frames, per-frame permutations (T, Q)), where ``perms[t]``
    reorders frame t's queries into frame 0's order. Each frame is matched
    to the previous frame's aligned embeddings, so the alignment is causal:
    frames after the last valid one change nothing before it."""
    Q = pred_embds.shape[1]
    prev = pred_embds[0]
    perms = [torch.arange(Q, device=pred_embds.device)]
    for t in range(1, pred_embds.shape[0]):
        idx = match_from_embds(prev, pred_embds[t], solver=solver)
        prev = pred_embds[t][idx]
        perms.append(idx)
    perms = torch.stack(perms)
    logits_all = pred_logits[torch.arange(len(perms), device=perms.device)[:, None], perms]
    if valid is None:
        return logits_all.mean(dim=0), perms
    w = valid.to(logits_all.dtype)[:, None, None]
    return (logits_all * w).sum(dim=0) / torch.clamp(w.sum(), min=1.0), perms


def minvis_post_processing(
    pred_logits: torch.Tensor,  # (T, Q, K+1)
    pred_masks: torch.Tensor,  # (T, Q, H, W)
    pred_embds: torch.Tensor,  # (T, Q, C)
    valid: Optional[torch.Tensor] = None,
    solver: str = "jv",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean logits (Q, K+1), aligned masks (Q, T, H, W)): the masks of each
    frame gathered by its permutation from :func:`minvis_alignment`."""
    mean_logits, perms = minvis_alignment(pred_logits, pred_embds, valid, solver)
    frames = torch.arange(len(perms), device=pred_masks.device)[:, None]
    return mean_logits, pred_masks[frames, perms.to(pred_masks.device)].transpose(0, 1)


def topk_select(
    mask_cls: torch.Tensor,  # (Q, K+1)
    topk: int,
    aux_pred_cls: Optional[torch.Tensor] = None,  # (Q, K+1)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat top-K over the (Q x K) score matrix. Returns (scores, labels,
    query indices), each (topk,). ``aux_pred_cls``: element-wise max of the
    two softmaxes, no renormalization. Among equal scores the lower flat
    index comes first, as ``jax.lax.top_k`` orders them: a stable descending
    sort, the same on the CPU and on the card (``torch.topk`` fixes no order
    among ties, and equal scores are real: a saturated softmax is exactly
    1.0)."""
    Q, K1 = mask_cls.shape
    K = K1 - 1
    topk = min(topk, Q * K)
    scores = mask_cls.float().softmax(-1)[:, :-1]
    if aux_pred_cls is not None:
        scores = torch.maximum(scores, aux_pred_cls.float().softmax(-1)[:, :-1])
    top_scores, top_idx = torch.sort(scores.reshape(-1), descending=True, stable=True)
    top_scores, top_idx = top_scores[:topk], top_idx[:topk]
    return top_scores, top_idx % K, torch.div(top_idx, K, rounding_mode="floor")


def upsample_masks(
    masks: torch.Tensor,  # (N, t, H4, W4) mask logits
    img_size: Tuple[int, int],
    output_size: Tuple[int, int],
    padded_size: Tuple[int, int],
) -> torch.Tensor:
    """Resize to the padded model input, crop the valid region, resize to the
    original resolution; returns (N, t, out_h, out_w) bool (> 0).

    ``jax.image.resize`` antialiases by default: on upsampling that is plain
    bilinear interpolation, on downsampling a triangle filter widened by the
    scale. The first stage always upsamples; the second gets
    ``antialias=True``, which is PyTorch's form of the same filter (and plain
    bilinear along any axis that upsamples)."""
    masks = masks.float()
    masks = F.interpolate(masks, size=tuple(padded_size), mode="bilinear", align_corners=False)
    masks = masks[:, :, : img_size[0], : img_size[1]]
    masks = F.interpolate(
        masks, size=tuple(output_size), mode="bilinear", align_corners=False, antialias=True
    )
    return masks > 0.0


class VideoInference(NamedTuple):
    scores: torch.Tensor  # (topk,)
    labels: torch.Tensor  # (topk,)
    masks: torch.Tensor  # (topk, T, H_out, W_out) bool


def inference_video(
    mask_cls: torch.Tensor,  # (Q, K+1)
    mask_pred: torch.Tensor,  # (Q, T, H4, W4)
    img_size: Tuple[int, int],  # valid region within the padded canvas (model scale)
    output_size: Tuple[int, int],  # original video resolution
    padded_size: Tuple[int, int],  # padded model input resolution
    topk: int = 10,
    aux_pred_cls: Optional[torch.Tensor] = None,
) -> VideoInference:
    """Top-K instances and their masks at the original resolution, in one
    shot: the (topk, T, out_h, out_w) tensor is materialized, so this is for
    short clips and tests; the eval loop pages the upsampling
    (``engine.inference.paged_inference_video``)."""
    scores, labels, queries = topk_select(mask_cls, topk, aux_pred_cls)
    masks = upsample_masks(mask_pred[queries.to(mask_pred.device)], img_size, output_size, padded_size)
    return VideoInference(scores=scores, labels=labels, masks=masks)
