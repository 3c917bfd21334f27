"""DVIS-DAQ streaming eval loop: VIS, VOS and MOTS, and the per-video
forward of the VPS and VSS loops.

Counterpart: ``dvis_plus_tpu/engine/daq_inference.py`` (``SeqRecord`` :45,
``stream_video`` :99, ``collect_sequences`` :174,
``daq_video_logits_masks`` :223, ``run_daq_inference`` :246,
``_offline_refine`` :307, ``_vos_output`` :418). Signatures are the JAX
ones without ``params`` and the executable cache: the module holds its
weights.

Per window the segmenter runs once (the tail window padded by repeating
its last frame), then the cutter steps each real frame with its slot table
carried on the device. The window's slot-aligned outputs are stacked on the
device and read back once a window, the masks rounded to fp16 first (the
JAX loop rounds them on the host; the values are the same). On the host the
outputs accumulate per stable sequence id; sequences shorter than
``noise_frame_num`` frames that end before the video does are dropped, the
class logits are averaged over a sequence's frames and its masks fill a
(T, H4, W4) stride-4 video with -1e4 where it is absent. Offline, the
``offline_topk_num`` best sequences (padded to that count and masked)
go through the temporal refiner: the JAX loop runs the segmenter a second
time to get back the frame queries and mask features; here the streaming
pass keeps them (on the device while the video fits
``eval_mask_budget_bytes``, as the DVIS++ offline loop does), so B1 runs 6
times a window instead of 12, with the same result. The DAQ loop has no
pipeline worker and no prefetch, as in the JAX package.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dvis_plus_tpu_torch.config import check_supported
from dvis_plus_tpu_torch.engine.inference import (
    _frames,
    _pad_to,
    _to_host,
    eval_mask_budget_bytes,
    paged_inference_video,
    resolve_window_size,
)
from dvis_plus_tpu_torch.models.daq.cutter import init_cutter_state
from dvis_plus_tpu_torch.models.segmenter.pixel_decoder import dtype_of
from dvis_plus_tpu_torch.utils import trace

logger = logging.getLogger(__name__)


class SeqRecord:
    """Host-side accumulator of one sequence (the reference's
    ``VideoInstanceSequence``)."""

    __slots__ = ("start", "frames", "logits", "masks", "embeds", "sg_pos")

    def __init__(self, start: int):
        self.start = start
        self.frames: List[int] = []
        self.logits: List[np.ndarray] = []
        self.masks: List[np.ndarray] = []
        self.embeds: List[np.ndarray] = []
        self.sg_pos: Optional[np.ndarray] = None


def _read_window(outs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The window's stacked slot outputs to the host in one wait: masks
    as fp16, logits and embeds as fp32."""
    cast = {"slot_masks": torch.float16, "slot_logits": torch.float32,
            "slot_embeds": torch.float32, "slot_sg_pos": torch.float32}
    copies = {k: _to_host(v.to(cast[k]) if k in cast else v) for k, v in outs.items()}
    done = list(copies.values())[-1][1]  # the last copy issued: the stream has done the others
    if done is not None:
        done.synchronize()
    return {k: host.numpy() for k, (host, _) in copies.items()}


def stream_video(cfg, model, images: np.ndarray, keep_features: bool = False, image_size=None):
    """The streaming cutter over one video (T, H, W, 3): the eval mapper's
    uint8 canvas with its valid ``image_size``, or a normalized float32 one
    (``inference._frames``). Returns
    (records {seq_id: SeqRecord}, T, (H4, W4), features): ``features`` is
    None, or with ``keep_features`` (the offline pass) the frame queries
    (T, fQ, C) on the device and the per-window mask features (W_sz, Cm,
    H4, W4), on the device or, beyond the memory budget, on the host."""
    dev = next(model.parameters()).device
    W_sz = resolve_window_size(cfg)
    T = images.shape[0]
    n_windows = (T + W_sz - 1) // W_sz
    images = _pad_to(images, n_windows * W_sz)
    Him, Wim = images.shape[1:3]
    d = cfg.model.daq
    C = cfg.model.transformer_decoder.hidden_dim
    state = init_cutter_state(d.max_num_instances, C, dtype_of(cfg.model.compute_dtype), dev)
    keep_on_device = n_windows * W_sz * (Him // 4) * (Wim // 4) * 256 * 4 < eval_mask_budget_bytes(cfg)

    records: Dict[int, SeqRecord] = {}
    frame_l, mf_l = [], []
    shape4 = None
    for w in range(n_windows):
        seg = model.segment_only(_frames(images[w * W_sz : (w + 1) * W_sz], dev, cfg, image_size,
                                         min(W_sz, T - w * W_sz)))
        lg, pm = seg["pred_logits"], seg["pred_masks"]
        fe, mf, qf = seg["pred_embds_without_norm"], seg["mask_features"], seg["query_feat"]
        shape4 = tuple(pm.shape[-2:])
        t0, t1 = w * W_sz, min((w + 1) * W_sz, T)
        if keep_features:
            frame_l.append(fe[: t1 - t0])
            mf_l.append(mf if keep_on_device else mf.cpu())
        outs = []
        if w == 0:
            # the first frame: validity from the segmenter's scores
            valid = lg[0].float().softmax(-1)[:, :-1].max(dim=1).values > d.aux_inference_select_thr
            out0, state = model.cutter_step(state, fe[0], mf[0], qf, pm[0], valid, first=True)
            outs.append({k: v[None] for k, v in out0.items()})
        s0, s1 = len(outs), t1 - t0  # the window's padded frames are not stepped
        if s1 > s0:
            steady, state = model.cutter_window(state, fe[s0:s1], mf[s0:s1], qf, pm[s0:s1])
            outs.append(steady)
        _record(records, _read_window({k: torch.cat([o[k] for o in outs]) for k in outs[0]}), t0)
    features = (torch.cat(frame_l), mf_l) if keep_features else None
    return records, T, shape4, features


def _record(records: Dict[int, SeqRecord], host: Dict[str, np.ndarray], t0: int) -> None:
    """Accumulate a window's stacked slot outputs, frame t0 first."""
    for j in range(host["alive"].shape[0]):
        for slot in np.nonzero(host["alive"][j])[0]:
            sid = int(host["seq_id"][j, slot])
            rec = records.get(sid)
            if rec is None:
                rec = records[sid] = SeqRecord(t0 + j)
            rec.frames.append(t0 + j)
            rec.logits.append(host["slot_logits"][j, slot])
            rec.masks.append(host["slot_masks"][j, slot])
            rec.embeds.append(host["slot_embeds"][j, slot])
            rec.sg_pos = host["slot_sg_pos"][j, slot]


def collect_sequences(cfg, records: Dict[int, SeqRecord], T: int, shape4):
    """Noise filter and assembly of the sequences, in seq id order: (mean
    class logits (N, K+1) fp32, masks (N, T, H4, W4) fp16 with -1e4 where
    absent, embeds (N, T, C) fp32 with the last SGFF embed where absent,
    time_valid (N, T), seq ids)."""
    H4, W4 = shape4
    cls_l, masks_l, emb_l, tv_l, ids = [], [], [], [], []
    nf = cfg.model.daq.noise_frame_num
    for sid, rec in sorted(records.items()):
        if len(rec.frames) < nf and rec.frames[-1] + 1 < T:
            continue
        full = np.full((T, H4, W4), -1e4, np.float16)
        emb = np.tile(rec.sg_pos[None], (T, 1))  # absent frames: the SGFF embed
        tv = np.zeros((T,), bool)
        for f, m, e in zip(rec.frames, rec.masks, rec.embeds):
            full[f] = m
            emb[f] = e
            tv[f] = True
        cls_l.append(np.stack(rec.logits, axis=0).mean(axis=0))
        masks_l.append(full)
        emb_l.append(emb)
        tv_l.append(tv)
        ids.append(sid)
    if not cls_l:
        return (np.zeros((0, cfg.model.num_classes + 1), np.float32),
                np.zeros((0, T, H4, W4), np.float16),
                np.zeros((0, T, cfg.model.transformer_decoder.hidden_dim), np.float32),
                np.zeros((0, T), bool), [])
    return np.stack(cls_l), np.stack(masks_l), np.stack(emb_l), np.stack(tv_l), ids


def _pad_rows(a: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    if a.shape[0] >= n:
        return a[:n]
    return np.concatenate([a, np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)], axis=0)


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _video_sequences(cfg, model, images: np.ndarray, image_size=None):
    """The streaming pass, the sequences, and offline the refiner over the
    best ones: (class logits (N, K+1) fp32, masks (N, T, H4, W4) fp16)."""
    offline = cfg.model.meta_architecture == "daq_offline"
    records, T, shape4, features = stream_video(cfg, model, images, keep_features=offline,
                                                image_size=image_size)
    pred_cls, full_masks, embeds, _, _ = collect_sequences(cfg, records, T, shape4)
    if offline and pred_cls.shape[0] > 0:
        pred_cls, full_masks = _offline_refine(cfg, model, pred_cls, embeds, features)
    return pred_cls, full_masks


def _bucketed(pred_cls: np.ndarray, full_masks: np.ndarray, dev):
    """Pad the sequences to a multiple of 16 rows (at least 16) with -1e4
    masks and a no-object logit of 1.0, as the JAX loop does: (logits
    (N', K+1) on ``dev``, masks (N', T, H4, W4) fp32 on the host)."""
    N = pred_cls.shape[0]
    bucket = max(16, ((N + 15) // 16) * 16)
    logits = _pad_rows(pred_cls.astype(np.float32), bucket, fill=-1e4)
    logits[N:, -1] = 1.0
    masks = _pad_rows(full_masks.astype(np.float32), bucket, fill=-1e4)
    return torch.from_numpy(logits).to(dev), torch.from_numpy(masks)


def daq_video_logits_masks(cfg, model, images: np.ndarray, image_size=None):
    """The DAQ video forward of the VPS and VSS loops over ``images`` with
    its valid ``image_size`` (:func:`stream_video`): (sequence logits
    (N', K+1) on the model's device, masks (N', T, H4, W4) fp32 on the
    host), N' padded as :func:`_bucketed` says."""
    pred_cls, full_masks = _video_sequences(cfg, model, images, image_size)
    return _bucketed(pred_cls, full_masks, next(model.parameters()).device)


def run_daq_inference(cfg, model, loader: Iterator[dict], evaluator,
                      timings: Optional[dict] = None):
    """DAQ eval loop: streaming cutter -> (offline: refiner) -> top-K masks
    (``test.mask_download``) -> ``evaluator.process`` per video, or with
    ``test.task=vos`` the per-frame PNGs of :func:`_vos_output`. A plain
    loop: no pipeline worker, no prefetch. ``timings`` (optional dict)
    accumulates ``model_s`` (streaming pass, sequences, refiner), ``post_s``
    (top-K, upsample, download, evaluator rows) and of it ``rows_s`` (the
    evaluator rows) in wall seconds: the tracer's spans ``eval.forward``,
    ``eval.post`` and ``eval.evaluator`` (``utils/trace.py``)."""
    check_supported(cfg)
    dev = next(model.parameters()).device
    W_sz = resolve_window_size(cfg)
    with torch.inference_mode():
        for sample in loader:
            images = sample["images"]
            H, W = images.shape[1:3]
            video = sample.get("video_id", 0)
            vos = cfg.test.task == "vos"  # writes PNGs and keeps no timings
            with trace.span("eval.forward", video, None if vos else timings, "model_s"):
                pred_cls, full_masks = _video_sequences(cfg, model, images, sample["image_size"])
            if vos:
                _vos_output(cfg, sample, pred_cls, full_masks)
                continue
            with trace.span("eval.post", video, timings, "post_s"):
                logits, masks = _bucketed(pred_cls, full_masks, dev)
                h, w = [int(v) for v in sample["image_size"]]
                scores, labels, out_masks = paged_inference_video(
                    logits, masks, img_size=(h, w),
                    output_size=(int(sample["height"]), int(sample["width"])),
                    padded_size=(H, W), topk=min(cfg.test.max_num, logits.shape[0]), chunk=W_sz,
                    download=getattr(cfg.test, "mask_download", "runs"),
                    k_col=getattr(cfg.test, "rle_col_k", 8),
                )
                with trace.span("eval.evaluator", video, timings, "rows_s"):
                    evaluator.process(video, {
                        "pred_scores": scores.cpu().tolist(),
                        "pred_labels": labels.cpu().tolist(),
                        "pred_masks": out_masks,
                    })


def _offline_refine(cfg, model, pred_cls: np.ndarray, embeds: np.ndarray, features):
    """The temporal refiner over the ``offline_topk_num`` best sequences:
    (refined class logits (N, K+1) fp32, masks (N, T, H4, W4) fp16), N the
    refined count. The sequences are ranked by numpy's ``argsort`` on the
    host, as in the JAX loop (its order among equal scores is numpy's), and
    padded to ``offline_topk_num`` rows that the refiner's object attention
    masks out. The refiner runs in fp32: its instance embeds come from the
    host in fp32, and the JAX projections promote the frame queries to
    their dtype."""
    dev = next(model.parameters()).device
    W_sz = resolve_window_size(cfg)
    topk = cfg.model.daq.offline_topk_num
    scores = _softmax(pred_cls)[:, :-1].max(axis=1)
    order = np.argsort(-scores)[:topk]
    sel_emb = embeds[order]
    N, T, _ = sel_emb.shape
    Qr = max(topk, 1)
    inst = torch.from_numpy(_pad_rows(sel_emb, Qr)).to(dev)  # (Qr, T, C)
    inst_mask = torch.arange(Qr, device=dev) < N
    frame_embeds, mf_l = features  # (T, fQ, C); per window (W_sz, Cm, H4, W4)
    r = model.refine_embeds(inst.transpose(0, 1)[None], frame_embeds.float()[None], inst_mask[None])
    membd = r["mask_embed"]  # (1, T, Qr, Cm)
    masks_l = []
    for w, mf in enumerate(mf_l):
        t0, t1 = w * W_sz, min((w + 1) * W_sz, T)
        mw = model.refine_mask_window(membd[:, t0:t1], mf[None, : t1 - t0].to(dev))[0]
        masks_l.append(mw.half().cpu())  # (Qr, Tw, H4, W4), rounded as the JAX loop's
    r_masks = torch.cat(masks_l, dim=1).numpy()
    # the reference DAQ takes the refiner's logits as they are: no fusion
    # with the online sequence logits
    return r["pred_logits"][0, :N].float().cpu().numpy(), r_masks[:N]


def _resize(x: torch.Tensor, size, mode: str) -> torch.Tensor:
    """(n, H, W) -> (n, *size); ``nearest`` takes source pixel floor(i *
    scale), ``bilinear`` samples at half-pixel centres without antialiasing
    (OpenCV's ``INTER_NEAREST`` and ``INTER_LINEAR``)."""
    kw = {} if mode == "nearest" else {"align_corners": False}
    return F.interpolate(x[None], size=tuple(size), mode=mode, **kw)[0]


def _vos_output(cfg, sample: dict, pred_cls: np.ndarray, full_masks: np.ndarray) -> None:
    """VOS: the first frame's given objects (``first_frame_masks`` (Ng, H, W)
    bool at model resolution, ``first_frame_ids``) are matched to the top-K
    sequences by the IoU of their first-frame masks (exact assignment), then
    each frame's label map (argmax over the matched sequences' upsampled
    logits, background where none is positive) is written as an 8-bit PNG
    under ``<output_dir>/inference/<video>/``. No mapper gives first-frame
    masks, in the JAX package as here, so a sample without them is skipped
    with a warning. The resizes are torch's; the JAX loop's are OpenCV's."""
    from dvis_plus_tpu_torch.ops.hungarian import hungarian
    from dvis_plus_tpu_torch.utils.png import write_png

    gt_masks = sample.get("first_frame_masks")
    ori_ids = sample.get("first_frame_ids", [])
    if gt_masks is None or len(ori_ids) == 0 or pred_cls.shape[0] == 0:
        logger.warning("VOS sample without first-frame targets; skipping")
        return
    T = full_masks.shape[1]
    H4, W4 = full_masks.shape[-2:]
    max_num = min(cfg.test.max_num, pred_cls.shape[0])
    scores = _softmax(pred_cls)[:, :-1].max(axis=1)
    top = np.argsort(-scores)[:max_num]
    topk_masks = torch.from_numpy(full_masks[top].astype(np.float32))  # (M, T, H4, W4)

    gt4 = _resize(torch.from_numpy(np.asarray(gt_masks, np.uint8)), (H4, W4), "nearest").bool()
    pred0 = topk_masks[:, 0] > 0.0
    inter = (pred0[:, None] & gt4[None]).flatten(2).sum(-1)
    union = (pred0[:, None] | gt4[None]).flatten(2).sum(-1)
    iou = inter.double() / torch.clamp(union, min=1).double()  # (M_pred, Ng)
    # each given object (row) takes a distinct predicted track (column)
    ng = min(len(ori_ids), iou.shape[0])
    track4gt = hungarian((1.0 - iou.T[:ng]).float())[0].tolist()
    obj_to_track = {int(ori_ids[g]): int(track4gt[g]) for g in range(ng)}

    out_h, out_w = int(sample["height"]), int(sample["width"])
    h, w = [int(v) for v in sample["image_size"]]
    pad_h, pad_w = sample["images"].shape[1:3]
    video_id = sample.get("video_name", str(sample.get("video_id", 0)))
    save_dir = os.path.join(cfg.output_dir, "inference", str(video_id))
    os.makedirs(save_dir, exist_ok=True)
    oids = sorted(obj_to_track)
    for t in range(T):
        m = _resize(topk_masks[[obj_to_track[o] for o in oids], t], (pad_h, pad_w), "bilinear")
        m = _resize(m[:, :h, :w], (out_h, out_w), "bilinear")  # (n_obj, out_h, out_w)
        merge = torch.zeros(max(oids) + 1, out_h, out_w)
        merge[oids] = m
        merge[0] = torch.prod(1.0 - (m > 0.0).float(), dim=0)
        lab = torch.argmax(merge, dim=0).to(torch.uint8).numpy()
        name = sample["file_names"][t] if "file_names" in sample else f"{t:05d}.jpg"
        base = os.path.basename(name).rsplit(".", 1)[0] + ".png"
        write_png(os.path.join(save_dir, base), lab)
