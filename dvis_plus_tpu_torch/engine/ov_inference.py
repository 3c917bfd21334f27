"""OV-DVIS++ eval loop: windowed forwards, the CLIP out-of-vocabulary head
and the geometric ensemble.

Counterpart: ``dvis_plus_tpu/engine/ov_inference.py``
(``ov_video_logits_masks_fn`` :33, ``run_ov_inference`` :76,
``_minvis_ov_video`` :135, ``_online_ov_video`` :220, ``_offline_ov_video``
:281). Per window the predicted masks pool the stride-32 CLIP features
(``pool_clip``), the CLIP logits are fused with the model's per frame
(``ov_ensemble_inference``), and the video's logits are the mean of its
true frames' fused log-probabilities (a geometric mean of the frame
probabilities); the masks then go through the VIS top-K and download of
``engine/inference.py`` (``runs`` by default, with the eval pipeline), or
through the VPS / VSS heads (``logits_masks_fn=`` of
``run_vps_inference`` / ``run_vss_inference``). No aux logits anywhere.

- MinVIS OV reuses ``inference._minvis_video`` (both paging branches) with
  the ensemble as its window, and DVIS++ online OV reuses the online half of
  ``inference._online_video``.
- DVIS++ offline OV (:func:`_offline_ov_video`): the streaming pass keeps
  each window's tracker embeds, frame embeds, mask features and CLIP
  features (no tracker heads: their logits are discarded there); one
  refiner embed pass; then per window the refined masks, their in-vocabulary
  pooling sums (``mf_sum`` / ``mf_cnt``, fp32) and the CLIP logits under
  them; the refiner classifies the pooled sums once. The masks are rounded
  to fp16, as the JAX loop stores them. The JAX loop pads the last window
  by repeating its last frame and adds the padded frames into ``mf_sum`` /
  ``mf_cnt``, so its in-vocabulary logits depend on T mod the window; the
  reference pools the video's own frames, and so does this loop: the two
  agree where T is a whole number of windows (ROADMAP "Tree state").
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dvis_plus_tpu_torch.config import ov_arch
from dvis_plus_tpu_torch.engine.inference import (
    _frames,
    _minvis_video,
    _online_video,
    _pad_to,
    eval_mask_budget_bytes,
    resolve_window_size,
    run_vis_inference,
)
from dvis_plus_tpu_torch.models.meta.ov import ov_ensemble_inference
from dvis_plus_tpu_torch.models.ov.heads import get_classification_logits
from dvis_plus_tpu_torch.models.segmenter.pixel_decoder import dtype_of
from dvis_plus_tpu_torch.models.tracker.referring_tracker import init_tracker_state


class OVContext(NamedTuple):
    """One test set's classifier on the model's device."""

    text_classifier: torch.Tensor  # (R, Cc) fp32, with the void rows
    num_templates: tuple
    overlap: torch.Tensor  # (K,) 1 = seen in training
    alpha: float
    beta: float

    def ensemble(self, model, in_vocab_logits, clip_dense, masks):
        """Fused (T, Q, K+1) log-probabilities of the model's logits and the
        CLIP embeddings pooled under ``masks`` (T, Q, H4, W4)."""
        pooled = model.pool_clip(clip_dense, masks)
        return ov_ensemble_inference(in_vocab_logits, pooled, self.text_classifier,
                                     self.num_templates, model.clip_logit_scale(), self.overlap,
                                     self.alpha, self.beta)


def ov_video_logits_masks_fn(cfg, model, text_classifier, num_templates: Sequence[int],
                             category_overlapping, void_index: Optional[int] = None):
    """``f(images, image_size=None) -> (fused log-probs (Q, K+1), masks
    (Q, T', H4, W4))`` (``images`` and its valid ``image_size`` as
    ``inference._frames`` takes them) for
    the architecture of ``cfg`` (MinVIS / CTVIS, DVIS++ online or offline),
    the open-vocabulary twin of ``inference.video_logits_masks``: what the
    VIS, VPS and VSS loops take as ``logits_masks_fn``. ``text_classifier``:
    (R, Cc) host array without the void rows (appended here, dataset
    ``void_index``'s private row or the merged ones); ``category_overlapping``
    (K,)."""
    arch = ov_arch(cfg)
    W_sz = resolve_window_size(cfg)
    dev = next(model.parameters()).device
    tc = torch.as_tensor(np.asarray(text_classifier, np.float32), device=dev)
    nt = tuple(num_templates)
    with torch.no_grad():
        tc = model.with_void(tc, nt, void_index)
    ov = OVContext(tc, nt, torch.as_tensor(np.asarray(category_overlapping, np.float32), device=dev),
                   cfg.model.ov.geometric_ensemble_alpha, cfg.model.ov.geometric_ensemble_beta)

    def minvis_window(model, frames):
        out = model(frames, ov.text_classifier, nt)
        fused = ov.ensemble(model, out["pred_logits"], out["clip_vis_dense"], out["pred_masks"])
        return fused, out["pred_masks"], out["pred_embds"]

    def online_window(model, frames, state):
        seg_out, track_out, state = model(frames[None], ov.text_classifier, nt, state=state)
        masks = track_out["pred_masks"][0]  # (Q, Tw, H4, W4)
        fused = ov.ensemble(model, track_out["pred_logits"][0], seg_out["clip_vis_dense"],
                            masks.transpose(0, 1))
        return fused, masks, state

    def f(images: np.ndarray, image_size=None):
        if arch in ("minvis_ov", "ctvis"):
            logits, masks, _ = _minvis_video(cfg, model, images, W_sz, minvis_window, image_size)
        elif arch == "dvis_online_ov":
            logits, masks, _ = _online_video(cfg, model, images, W_sz, online_window, image_size)
        else:
            logits, masks = _offline_ov_video(cfg, model, images, W_sz, ov, image_size)
        return logits, masks

    return f


def run_ov_inference(cfg, model, loader: Iterator[dict], evaluator, text_classifier,
                     num_templates: Sequence[int], category_overlapping,
                     void_index: Optional[int] = None, timings: Optional[dict] = None):
    """Open-vocabulary VIS eval loop: ``inference.run_vis_inference`` (its
    top-K, ``test.mask_download``, pipeline and ``timings``) over
    :func:`ov_video_logits_masks_fn`."""
    fn = ov_video_logits_masks_fn(cfg, model, text_classifier, num_templates,
                                  category_overlapping, void_index)
    run_vis_inference(cfg, model, loader, evaluator, timings, logits_masks_fn=fn)


def _offline_ov_video(cfg, model, images: np.ndarray, W_sz: int, ov: OVContext, image_size=None):
    """DVIS++ offline OV over one video (see the module docstring). Returns
    (fused log-probs (Q, K+1), refined masks (Q, T, H4, W4) fp16, on the
    device or, beyond the memory budget, on the host)."""
    dev = next(model.parameters()).device
    td = cfg.model.transformer_decoder
    tc, nt = ov.text_classifier, ov.num_templates
    state = init_tracker_state(1, td.num_queries, td.hidden_dim, dtype_of(cfg.model.compute_dtype), dev)
    T = images.shape[0]
    n_windows = (T + W_sz - 1) // W_sz
    images = _pad_to(images, n_windows * W_sz)
    Him, Wim = images.shape[1:3]
    # the mask features stay on the device while the whole video fits the
    # budget (256 fp32 channels at stride 4, as the close-vocabulary loop)
    keep_on_device = n_windows * (Him // 4) * (Wim // 4) * 256 * 4 * W_sz < eval_mask_budget_bytes(cfg)
    inst_l, frame_l, mf_l, clip_l = [], [], [], []
    for i in range(n_windows):
        frames = _frames(images[i * W_sz : (i + 1) * W_sz], dev, cfg, image_size,
                         min(W_sz, T - i * W_sz))[None]
        inst, frame, mf, clip_d, state = model.online_step(frames, tc, nt, state)
        inst_l.append(inst)
        frame_l.append(frame)
        mf_l.append(mf if keep_on_device else mf.cpu())
        clip_l.append(clip_d if keep_on_device else clip_d.cpu())
    inst = torch.cat(inst_l, dim=1)[:, :T]
    frame = torch.cat(frame_l, dim=1)[:, :T]
    r = model.refine_embeds(inst, frame)
    fused, membd = r["fused"], r["mask_embed"]  # (1, 1, Q, C), (1, T, Q, Cm)

    scale = model.clip_logit_scale()
    masks_l, out_l = [], []
    mf_sum = mf_cnt = 0.0
    for i in range(n_windows):
        t0, t1 = i * W_sz, min((i + 1) * W_sz, T)
        mf_w = mf_l[i][:, : t1 - t0].to(dev)
        mw = model.refine_mask_window(membd[:, t0:t1], mf_w)[0]  # (Q, tw, H4, W4) fp32
        m = (mw > 0.0).float()
        mf_sum = mf_sum + torch.einsum("qthw,tchw->qc", m, mf_w[0].float())
        mf_cnt = mf_cnt + m.sum(dim=(1, 2, 3))
        pooled = model.pool_clip(clip_l[i][: t1 - t0].to(dev), mw.transpose(0, 1))
        out_l.append(get_classification_logits(pooled, tc, scale, nt))  # (tw, Q, K+1)
        mh = mw.half()
        masks_l.append(mh if keep_on_device else mh.cpu())
    pooled = (mf_sum / torch.clamp(mf_cnt[:, None], min=1e-8))[None].to(fused.dtype)
    in_vocab = model.refine_ov_classify(fused, pooled, tc, nt)[0]  # (Q, K+1)
    out_logits = torch.cat(out_l)  # (T, Q, K+1)
    fused_frames = ov_ensemble_inference(
        in_vocab.expand(out_logits.shape), None, tc, nt, scale, ov.overlap, ov.alpha, ov.beta,
        out_vocab_logits=out_logits)
    return fused_frames.float().mean(dim=0), torch.cat(masks_l, dim=1)
