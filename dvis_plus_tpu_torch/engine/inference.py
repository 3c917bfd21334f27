"""Eval loops: windowed streaming inference over whole videos for the VIS,
VPS and VSS tasks.

Counterpart: ``dvis_plus_tpu/engine/inference.py`` (``resolve_window_size``
:27, ``eval_mask_budget_bytes`` :45, ``_upsample_runs`` :83,
``paged_inference_video`` :132, ``_prefetch`` :244, ``run_vis_inference``
:274, ``video_logits_masks`` :375, ``run_vps_inference`` :395,
``run_vss_inference`` :456, ``_minvis_video`` :520, ``_clipformer_video``
:595, ``_online_video`` :620-777 with its online and offline halves); the
DVIS-DAQ eval loop is ``engine/daq_inference.py``.
Signatures are the JAX ones without ``params``: the module holds its
weights.

Frames are cut into windows of ``test.window_size`` (the tail window is
padded by repeating the last frame). DVIS++ streams the tracker carry across
windows; MinVIS and CTVIS run the segmenter per window and align the queries
of every frame afterwards; Video Mask2Former decodes the whole video in one
clip-joint forward. Each video's top-K masks are upsampled a chunk of frames
at a time and thresholded on the device, and leave it as the COCO RLE's
per-column change rows (``test.mask_download=runs``, the default) or
bit-packed (``packed``); the two give the same ``results.json`` bytes. The
next chunk is issued before the previous one's copy is waited for. With
``test.eval_pipeline`` (the default) each video's post-processing runs on a
worker thread while the next video's windows run, and the loader is read
one video ahead on a thread of its own.

The JAX eval loop pads the time axis of the offline refiner's embed pass,
of the MinVIS alignment and of the clip forward to a power-of-two window
count by replicating the last real frame (``_bucket_windows`` :491,
``_pad_time_replicate`` :502), only to bound its per-shape compiles; eager
PyTorch has none and runs the true length T. The refiner and the alignment
mask the padding, so the two give the same real-frame outputs
(``tests/test_torch_dvis_offline.py``, ``tests/test_torch_minvis.py``).
The clip decoder attends over every frame it is given and normalizes the
temporal position encoding by the clip length, so a padded clip gives other
outputs; the port runs the true T, as the reference does (one forward over
the video), and equals the JAX loop where its bucket holds exactly T frames.
"""
from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from dvis_plus_tpu_torch.config import check_supported, is_ov
from dvis_plus_tpu_torch.models.meta.dvis_online import (
    online_post_processing,
    panoptic_probs,
    panoptic_scores,
    panoptic_segments_device,
    semantic_inference,
)
from dvis_plus_tpu_torch.models.meta.minvis import (
    minvis_alignment,
    minvis_post_processing,
    topk_select,
    upsample_masks,
)
from dvis_plus_tpu_torch.models.segmenter.pixel_decoder import dtype_of
from dvis_plus_tpu_torch.models.tracker.referring_tracker import init_tracker_state
from dvis_plus_tpu_torch.utils.rle import ColRunMasks, PackedMasks


def resolve_window_size(cfg) -> int:
    """``test.window_size <= 0`` = auto window sized to a memory budget."""
    W_sz = cfg.test.window_size
    if W_sz <= 0:
        div = cfg.model.size_divisibility
        H = (cfg.input.min_size_test + div - 1) // div * div
        W = (cfg.input.max_size_test + div - 1) // div * div
        per_frame = cfg.model.transformer_decoder.num_queries * (H // 4) * (W // 4) * 4
        W_sz = 5
        while W_sz > 1 and per_frame * W_sz * 8 > 12 * 1024**3:
            W_sz -= 1
    return W_sz


def eval_mask_budget_bytes(cfg) -> float:
    """Device budget for whole-video eval tensors: videos beyond it page
    window by window through the host (``test.offline_mf_budget_gb``; the
    environment variable ``DVIS_OFFLINE_MF_BUDGET_GB`` overrides it)."""
    gb = os.environ.get("DVIS_OFFLINE_MF_BUDGET_GB", "")
    if gb:
        return float(gb) * 1e9
    return float(getattr(cfg.test, "offline_mf_budget_gb", 4.0)) * 1e9


def _packbits(x: torch.Tensor) -> torch.Tensor:
    """MSB-first bit-pack of a bool tensor along the last axis (numpy
    ``packbits`` order) -> uint8."""
    W = x.shape[-1]
    if W % 8:
        x = torch.nn.functional.pad(x, (0, 8 - W % 8))
    bits = x.reshape(*x.shape[:-1], -1, 8).to(torch.int32)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=x.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def _upsample_pack(sel, img_size, output_size, padded_size) -> torch.Tensor:
    return _packbits(upsample_masks(sel, img_size, output_size, padded_size))


def _upsample_runs(sel, img_size, output_size, padded_size, k_col: int) -> torch.Tensor:
    """Upsample, threshold, then the COCO RLE's run boundaries instead of
    pixels: per column of the (n, t, H, W) bool masks the ascending rows
    (1..H-1) where its value changes, at most ``min(k_col, H-1)`` of them
    (unused slots hold H+1), their count ``m_col``, the change across each
    column boundary (bit 0 of the jump slot; column 0 has none) and pixel
    (0, 0) in bit 1 of column 0's jump slot. One (n, t, W, k+2) int16
    payload: ``[..., :k]`` rows, ``[..., k]`` m_col, ``[..., k+1]`` the jump
    slot (the host reads it as uint16; H < 32766). A column with more than
    k changes is flagged by its m_col and its frame falls back to the
    packed download. The JAX version extracts the k smallest rows by k
    unrolled minimum passes; here a running count along the column ranks
    each change, and the first k are scattered to their slots (every other
    change lands in a spare slot k that is dropped): the same rows, in one
    pass over the mask."""
    up = upsample_masks(sel, img_size, output_size, padded_size)
    H = up.shape[-2]
    k = min(k_col, H - 1)
    d = up[..., 1:, :] != up[..., :-1, :]  # (n, t, H-1, W) changes within columns
    rank = d.to(torch.int32).cumsum(-2, dtype=torch.int32)  # 1 for a column's first change
    m_col = rank[..., -1, :]
    slot = torch.where(d & (rank <= k), rank - 1, k).long()
    pos = torch.arange(1, H, dtype=torch.int32, device=up.device)[:, None].expand(d.shape)
    rows = torch.full((*d.shape[:2], k + 1, d.shape[-1]), H + 1, dtype=torch.int32, device=up.device)
    rows = rows.scatter_(-2, slot, pos)[..., :k, :].transpose(-1, -2)
    jump = torch.zeros_like(m_col)
    jump[..., 1:] = up[..., 0, 1:] != up[..., H - 1, :-1]
    jump[..., 0] = up[..., 0, 0].to(torch.int32) * 2
    return torch.cat([rows, m_col[..., None], jump[..., None]], dim=-1).to(torch.int16)


def _to_host(x: torch.Tensor):
    """Start ``x``'s copy to the host. Returns (host tensor, event to wait
    for, or None when the copy is done)."""
    if x.device.type != "cuda":
        return x, None
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def paged_inference_video(
    mask_cls,
    mask_pred,  # (Q, T, H4, W4) tensor, on the device or paged to the host
    img_size,
    output_size,
    padded_size,
    topk: int = 10,
    aux_pred_cls=None,
    chunk: int = 16,
    packed: bool = False,
    download: Optional[str] = None,
    k_col: int = 8,
):
    """Top-K extraction with time-chunked upsampling: ``chunk`` frames at a
    time are gathered, upsampled and thresholded on the device of
    ``mask_cls`` and copied to the host, and chunk i+1 is issued before
    chunk i's copy is waited for. ``download`` (``test.mask_download``):

    - ``"runs"``: only the RLE run boundaries leave the device
      (:func:`_upsample_runs`, about 2 k_col + 4 bytes a column); frames
      where a column holds more than ``k_col`` changes are copied bit-packed
      instead. Returns a :class:`~dvis_plus_tpu_torch.utils.rle.ColRunMasks`.
    - ``"packed"``: bit-packed pixels, 8 a byte. Returns a
      :class:`~dvis_plus_tpu_torch.utils.rle.PackedMasks`.
    - ``None``: ``packed=True`` is ``"packed"``; ``packed=False`` is
      ``"packed"`` unpacked to a (n, T, H, W) bool array on the host.

    Masks shorter than two rows have no changes within a column and take the
    packed download. Returns (scores, labels, masks)."""
    want_array = download is None and not packed
    mode = download or "packed"
    if mode not in ("runs", "packed"):
        raise ValueError(f"mask download must be 'runs' or 'packed', got {download!r}")
    scores, labels, queries = topk_select(mask_cls, topk, aux_pred_cls)
    dev = mask_cls.device
    T = mask_pred.shape[1]
    n = int(scores.shape[0])
    oh, ow = int(output_size[0]), int(output_size[1])
    ow_b = (ow + 7) // 8
    sizes = (tuple(img_size), (oh, ow), tuple(padded_size))
    q = queries.to(mask_pred.device)
    if oh < 2:
        mode = "packed"

    def select(s0: int, s1: int) -> torch.Tensor:
        return mask_pred[q, s0:s1].to(dev, torch.float32)

    def issue(s0: int):
        s1 = min(s0 + chunk, T)
        if mode == "runs":
            return s0, s1, _to_host(_upsample_runs(select(s0, s1), *sizes, k_col))
        return s0, s1, _to_host(_upsample_pack(select(s0, s1), *sizes))

    if mode == "runs":
        k_eff = min(k_col, oh - 1)
        rows = np.zeros((n, T, ow, k_eff), np.uint16)
        m_col = np.zeros((n, T, ow), np.uint16)
        jumps = np.zeros((n, T, ow_b), np.uint8)
        first = np.zeros((n, T), bool)
    else:
        bits = np.zeros((n, T, oh, ow_b), np.uint8)

    pending = None
    for s0 in list(range(0, T, chunk)) + [None]:
        nxt = issue(s0) if s0 is not None else None  # queued ahead of the wait below
        if pending is not None:
            p0, p1, (host, done) = pending
            if done is not None:
                done.synchronize()
            if mode == "runs":
                pay = host.numpy().view(np.uint16)
                rows[:, p0:p1] = pay[..., :k_eff]
                m_col[:, p0:p1] = pay[..., k_eff]
                jump_slot = pay[..., k_eff + 1]
                first[:, p0:p1] = (jump_slot[..., 0] & 2) > 0
                jumps[:, p0:p1] = np.packbits((jump_slot & 1).astype(np.uint8), axis=-1)
            else:
                bits[:, p0:p1] = host.numpy()
        pending = nxt

    if mode == "packed":
        out = PackedMasks(bits, oh, ow)
        return scores, labels, out.unpack() if want_array else out
    fallback = {}
    over = m_col.max(axis=-1) > k_eff  # (n, T): frames that need their pixels
    for t0 in sorted({int(t) // chunk * chunk for _, t in np.argwhere(over)}):
        pk = _upsample_pack(select(t0, min(t0 + chunk, T)), *sizes).cpu().numpy()
        for i, t in np.argwhere(over[:, t0 : t0 + chunk]):
            fallback[(int(i), int(t) + t0)] = pk[i, t]
    return scores, labels, ColRunMasks(rows, m_col, jumps, first, oh, ow, fallback)


def _pad_to(images: np.ndarray, pad_T: int) -> np.ndarray:
    T = images.shape[0]
    if T == pad_T:
        return images
    return np.concatenate([images, np.repeat(images[-1:], pad_T - T, axis=0)], axis=0)


def _frames(images: np.ndarray, dev) -> torch.Tensor:
    """(T, H, W, 3) numpy -> (T, 3, H, W) on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(images)).to(dev).permute(0, 3, 1, 2)


def _segmenter_window(model, frames: torch.Tensor):
    """MinVIS / CTVIS window: (logits (Tw, Q, K+1), masks (Tw, Q, H4, W4),
    embeds (Tw, Q, C))."""
    out = model(frames)
    return out["pred_logits"], out["pred_masks"], out["pred_embds"]


def _minvis_video(cfg, model, images: np.ndarray, W_sz: int, window_fn=_segmenter_window):
    """MinVIS / CTVIS: the segmenter per window (``window_fn(model, frames)``,
    by default :func:`_segmenter_window`; the open-vocabulary loop passes
    its ensemble), then the query alignment over all frames. Returns (mean
    logits (Q, K+1), aligned masks (Q, T, H4, W4) on the device or, beyond
    the memory budget, paged to host fp16 and aligned there with the
    per-frame permutations, None)."""
    dev = next(model.parameters()).device
    solver = cfg.model.tracker.matcher_solver
    T = images.shape[0]
    n_windows = (T + W_sz - 1) // W_sz
    images = _pad_to(images, n_windows * W_sz)
    Him, Wim = images.shape[1:3]
    Q = cfg.model.transformer_decoder.num_queries
    page_to_host = n_windows * W_sz * Q * (Him // 4) * (Wim // 4) * 4 > eval_mask_budget_bytes(cfg)

    logits_l, masks_l, embds_l = [], [], []
    for i in range(n_windows):
        lg, mk, em = window_fn(model, _frames(images[i * W_sz : (i + 1) * W_sz], dev))
        logits_l.append(lg)
        masks_l.append(mk.to("cpu", torch.float16) if page_to_host else mk)  # (W_sz, Q, H4, W4)
        embds_l.append(em)
    logits = torch.cat(logits_l)[:T]  # (T, Q, K+1)
    embds = torch.cat(embds_l)[:T]
    masks = torch.cat(masks_l)[:T]  # (T, Q, H4, W4)
    if not page_to_host:
        mean_logits, aligned = minvis_post_processing(logits, masks, embds, solver=solver)
        return mean_logits, aligned, None
    mean_logits, perms = minvis_alignment(logits, embds, solver=solver)
    aligned = masks[torch.arange(T)[:, None], perms.cpu()].transpose(0, 1)  # host fp16
    return mean_logits, aligned, None


def _clipformer_video(cfg, model, images: np.ndarray, W_sz: int):
    """Video Mask2Former: one clip-joint forward over the whole video at its
    true length. Returns (clip logits (Q, K+1), masks (Q, T, H4, W4), None)."""
    out = model(_frames(images, next(model.parameters()).device)[None])
    return out["pred_logits"][0], out["pred_masks"][0], None


def _tracker_window(model, frames: torch.Tensor, state):
    """DVIS++ online window: (logits (Tw, Q, K+1), masks (Q, Tw, H4, W4),
    the carry)."""
    _, track_out, state = model(frames[None], state=state)
    return track_out["pred_logits"][0], track_out["pred_masks"][0], state


def _online_video(cfg, model, images: np.ndarray, W_sz: int, window_fn=_tracker_window):
    """DVIS online: the tracker carry streams across windows
    (``window_fn(model, frames, state)``, by default :func:`_tracker_window`;
    the open-vocabulary loop passes its ensemble); offline: the window
    outputs accumulate, then one refiner pass over the whole video. images
    (T, H, W, 3) normalized numpy. Returns (class logits (Q, K+1), masks
    (Q, T, H4, W4) on the device or paged to host fp16, aux logits (Q, K+1)
    or None)."""
    dev = next(model.parameters()).device
    td = cfg.model.transformer_decoder
    C2 = td.hidden_dim * (2 if td.reid_branch else 1)
    state = init_tracker_state(1, td.num_queries, C2, dtype_of(cfg.model.compute_dtype), dev)

    T = images.shape[0]
    n_windows = (T + W_sz - 1) // W_sz
    images = _pad_to(images, n_windows * W_sz)
    Him, Wim = images.shape[1:3]

    def window(i):
        return _frames(images[i * W_sz : (i + 1) * W_sz], dev)  # (W_sz, 3, H, W)

    if cfg.model.meta_architecture != "dvis_offline":
        # beyond the memory budget each window's masks page to host fp16
        mask_bytes = n_windows * W_sz * td.num_queries * (Him // 4) * (Wim // 4) * 4
        page_to_host = mask_bytes > eval_mask_budget_bytes(cfg)
        logits_l, masks_l = [], []
        for i in range(n_windows):
            lg, mk, state = window_fn(model, window(i), state)
            logits_l.append(lg)
            masks_l.append(mk.to("cpu", torch.float16) if page_to_host else mk)
        logits = torch.cat(logits_l, dim=0)[:T]  # (T, Q, K+1)
        masks = torch.cat(masks_l, dim=1)[:, :T]  # (Q, T, H4, W4)
        return online_post_processing(logits.float()), masks, None

    # Offline: the embeds accumulate on the device (small); the mask
    # features stay there while the whole video fits the budget (the JAX
    # eval loop's estimate: 256 fp32 channels at stride 4) and page to the
    # host per window beyond it, and so do the refined masks, as host fp16
    mf_bytes_per_window = (Him // 4) * (Wim // 4) * 256 * 4 * W_sz
    keep_on_device = n_windows * mf_bytes_per_window < eval_mask_budget_bytes(cfg)
    online_logits_l, inst_l, frame_l, mf_l = [], [], [], []
    for i in range(n_windows):
        lg, inst, frame, mf, state = model.online_step(window(i)[None], state)
        online_logits_l.append(lg[0])
        inst_l.append(inst)
        frame_l.append(frame)
        mf_l.append(mf if keep_on_device else mf.cpu())
    online_logits = torch.cat(online_logits_l, dim=0)[:T]  # (T, Q, K+1)
    inst = torch.cat(inst_l, dim=1)[:, :T]
    frame = torch.cat(frame_l, dim=1)[:, :T]

    n_sp = int(getattr(cfg.test, "refiner_shard_devices", 0))
    if n_sp > 1:  # the objects sharded over n_sp devices (parallel/sp.py)
        from dvis_plus_tpu_torch.parallel.sp import refiner_embed_pass_sharded, shard_devices

        r = refiner_embed_pass_sharded(model.refiner, inst, frame, shard_devices(n_sp, dev))
    else:
        r = model.refine_embeds(inst, frame)
    r_logits, membd = r["pred_logits"][0], r["mask_embed"]  # (Q, K+1), (1, T, Q, Cm)
    masks_l = []
    for i in range(n_windows):
        t0, t1 = i * W_sz, min((i + 1) * W_sz, T)
        mw = model.refine_mask_window(membd[:, t0:t1], mf_l[i][:, : t1 - t0].to(dev))[0]
        masks_l.append(mw if keep_on_device else mw.to("cpu", torch.float16))
    r_masks = torch.cat(masks_l, dim=1)  # (Q, T, H4, W4)
    # aux = the online logits' raw mean over time; the max-of-probabilities
    # fusion happens in topk_select after its softmax, without renormalizing
    aux = online_logits.float().mean(dim=0)  # (Q, K+1)
    return r_logits, r_masks, aux


_VIDEO_FNS = {"minvis": _minvis_video, "ctvis": _minvis_video,
              "maskformer": _clipformer_video, "video_maskformer": _clipformer_video}


def video_logits_masks(cfg, model, images: np.ndarray, W_sz: int):
    """The video's forward for ``model.meta_architecture``: (class logits
    (Q, K+1), masks (Q, T, H4, W4) on the device or paged to host fp16, aux
    logits (Q, K+1) or None). Only DVIS++ offline gives aux logits (the
    online tracker's logits averaged over time). DVIS-DAQ gives its
    sequences, padded to a multiple of 16 rows
    (``daq_inference.daq_video_logits_masks``)."""
    if cfg.model.meta_architecture.startswith("daq_"):
        from dvis_plus_tpu_torch.engine.daq_inference import daq_video_logits_masks

        return (*daq_video_logits_masks(cfg, model, images), None)
    return _VIDEO_FNS.get(cfg.model.meta_architecture, _online_video)(cfg, model, images, W_sz)


def _prefetch(it: Iterator, depth: int = 1) -> Iterator:
    """Read ``it`` on a daemon thread, ``depth`` items ahead, so that the
    loader's host work (frame decode, resize) overlaps the current video's
    device windows. An exception of the loader is raised in the caller."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    done = object()
    err: list = []

    def fill():
        try:
            for x in it:
                q.put(x)
        except BaseException as e:  # noqa: BLE001 - raised in the caller below
            err.append(e)
        finally:
            q.put(done)

    threading.Thread(target=fill, daemon=True, name="eval-prefetch").start()
    while True:
        x = q.get()
        if x is done:
            if err:
                raise err[0]
            return
        yield x


def run_vis_inference(cfg, model, loader: Iterator[dict], evaluator,
                      timings: Optional[dict] = None, logits_masks_fn=None):
    """VIS eval loop: the video's forward (by ``model.meta_architecture``:
    DVIS++ online or offline, MinVIS / CTVIS, Video Mask2Former, DVIS-DAQ) -> top-K
    masks (``test.mask_download``) -> ``evaluator.process`` per video.
    With ``test.eval_pipeline`` (the default) the post-processing of a video
    runs on one worker thread while the main thread runs the next video's
    forward (first in, first out, at most one video waiting), and the loader
    is read one video ahead; the rows are those of the plain loop, and an
    exception of the loader or of the worker is raised here. The worker
    enters inference mode and the model's CUDA device itself (both are per
    thread) and stays on the default stream, so it reads the main thread's
    tensors in stream order. ``timings`` (optional dict) accumulates
    ``model_s`` (the forwards, synchronized), ``post_s`` (top-K, upsample,
    download, evaluator rows) and ``rows_s`` (of it, the evaluator rows: the
    RLE encoding) in wall seconds; with the pipeline on, the forwards and the
    post-processing overlap, and the synchronization that ends ``model_s``
    also waits for the worker's device work queued before it. A setting the port cannot honour raises
    ``NotImplementedError`` (``config.check_supported``). DVIS-DAQ goes to
    ``daq_inference.run_daq_inference``, a plain loop, as in the JAX
    package. ``logits_masks_fn(images) -> (logits, masks)`` replaces the
    closed-vocabulary forward (the open-vocabulary loop,
    ``engine/ov_inference.py``, passes its ensemble); an open-vocabulary
    configuration needs it."""
    check_supported(cfg)
    _check_ov(cfg, logits_masks_fn)
    if cfg.model.meta_architecture.startswith("daq_"):
        from dvis_plus_tpu_torch.engine.daq_inference import run_daq_inference

        return run_daq_inference(cfg, model, loader, evaluator, timings)
    W_sz = resolve_window_size(cfg)
    dev = next(model.parameters()).device
    download = getattr(cfg.test, "mask_download", "runs")
    k_col = getattr(cfg.test, "rle_col_k", 8)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def post_and_process(sample, logits, masks, aux, H, W):
        on_device = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with torch.inference_mode(), on_device:
            t1 = time.perf_counter()
            h, w = [int(v) for v in sample["image_size"]]
            scores, labels, out_masks = paged_inference_video(
                logits, masks, img_size=(h, w),
                output_size=(int(sample["height"]), int(sample["width"])),
                padded_size=(H, W), topk=cfg.test.max_num, aux_pred_cls=aux,
                chunk=W_sz, download=download, k_col=k_col,
            )
            t2 = time.perf_counter()
            evaluator.process(
                sample.get("video_id", 0),
                {
                    "pred_scores": scores.cpu().tolist(),
                    "pred_labels": labels.cpu().tolist(),
                    "pred_masks": out_masks,
                },
            )
            if timings is not None:
                t3 = time.perf_counter()
                timings["post_s"] = timings.get("post_s", 0.0) + t3 - t1
                timings["rows_s"] = timings.get("rows_s", 0.0) + t3 - t2

    pipeline = bool(getattr(cfg.test, "eval_pipeline", True))
    executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="eval-post") if pipeline else None
    if pipeline:
        loader = _prefetch(loader)
    pending = None
    try:
        with torch.inference_mode():
            for sample in loader:
                images = sample["images"]  # (T, H, W, 3) numpy
                H, W = images.shape[1:3]
                t0 = time.perf_counter()
                logits, masks, aux = _forward(cfg, model, images, W_sz, logits_masks_fn)
                sync()
                if timings is not None:
                    timings["model_s"] = timings.get("model_s", 0.0) + time.perf_counter() - t0
                if executor is None:
                    post_and_process(sample, logits, masks, aux, H, W)
                    continue
                if pending is not None:
                    pending.result()  # at most one video waits for its post-processing
                pending = executor.submit(post_and_process, sample, logits, masks, aux, H, W)
            if pending is not None:
                pending.result()
    finally:
        if executor is not None:
            executor.shutdown(wait=True)


def _check_ov(cfg, logits_masks_fn) -> None:
    if is_ov(cfg) and logits_masks_fn is None:
        raise ValueError("an open-vocabulary model needs its text classifier: run it through "
                         "engine.ov_inference (python -m dvis_plus_tpu_torch.cli_ov)")


def _forward(cfg, model, images, W_sz, logits_masks_fn):
    """(logits, masks, aux) of the video: ``logits_masks_fn``'s, without aux,
    when given, else :func:`video_logits_masks`'s."""
    if logits_masks_fn is None:
        return video_logits_masks(cfg, model, images, W_sz)
    return (*logits_masks_fn(images), None)


def _task_chunks(cfg, model, loader, timings, logits_masks_fn=None):
    """Shared by the VPS and VSS loops: per video (sample, logits, aux,
    chunk iterator, padded (H, W)), where the iterator yields each
    ``W_sz``-frame time chunk of the masks on the model's device (masks
    paged to host fp16 come back one chunk at a time). ``model_s`` in
    ``timings`` accumulates the synchronized forwards."""
    check_supported(cfg)
    _check_ov(cfg, logits_masks_fn)
    W_sz = resolve_window_size(cfg)
    dev = next(model.parameters()).device
    for sample in loader:
        images = sample["images"]  # (T, H, W, 3) numpy
        T, H, W = images.shape[:3]
        t0 = time.perf_counter()
        logits, masks, aux = _forward(cfg, model, images, W_sz, logits_masks_fn)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if timings is not None:
            timings["model_s"] = timings.get("model_s", 0.0) + time.perf_counter() - t0
        masks = masks[:, :T]
        chunks = (masks[:, s0 : s0 + W_sz].to(dev) for s0 in range(0, T, W_sz))
        yield sample, logits, aux, chunks, (H, W)


def run_vps_inference(cfg, model, loader: Iterator[dict], evaluator, num_thing_classes: int,
                      timings: Optional[dict] = None, logits_masks_fn=None):
    """VPS eval loop: the video's forward, then per time chunk of ``W_sz``
    frames the upsampled mask probabilities and the per-pixel argmax query
    (``panoptic_probs``), the segment bookkeeping on the device
    (``panoptic_segments_device``), and the (T, H, W) int32 id map with its
    ``segments_infos`` to ``evaluator.process``. ``timings`` (optional dict)
    accumulates ``model_s`` (the forwards), ``post_s`` (everything after),
    of it ``segments_s`` (the host loop over the queries) and ``png_s`` (the
    evaluator: PNGs and rows), in wall seconds. ``logits_masks_fn`` as in
    :func:`run_vis_inference` (the open-vocabulary route)."""
    with torch.inference_mode():
        for sample, logits, aux, chunks, padded in _task_chunks(cfg, model, loader, timings,
                                                                logits_masks_fn):
            t1 = time.perf_counter()
            h, w = [int(v) for v in sample["image_size"]]
            out_size = (int(sample["height"]), int(sample["width"]))
            thr = cfg.test.object_mask_threshold
            per_chunk = (panoptic_probs(logits, chunk, img_size=(h, w), output_size=out_size,
                                        padded_size=padded, object_mask_threshold=thr,
                                        aux_pred_cls=aux)[3:]
                         for chunk in chunks)
            panoptic_seg, segments_infos, _ = panoptic_segments_device(
                *panoptic_scores(logits, thr, aux), per_chunk, num_thing_classes,
                cfg.test.overlap_threshold, timings)
            panoptic_seg = panoptic_seg.cpu().numpy()
            t2 = time.perf_counter()
            evaluator.process(sample.get("video_id", 0), sample["file_names"], panoptic_seg,
                              segments_infos)
            if timings is not None:
                t3 = time.perf_counter()
                timings["post_s"] = timings.get("post_s", 0.0) + t3 - t1
                timings["png_s"] = timings.get("png_s", 0.0) + t3 - t2


def run_vss_inference(cfg, model, loader: Iterator[dict], evaluator,
                      timings: Optional[dict] = None, logits_masks_fn=None):
    """VSS eval loop: the video's forward, then per time chunk the per-pixel
    semantic argmax (``semantic_inference``) on the device; only the
    (T, H, W) class map, as uint8 (the class ids the evaluator writes),
    leaves the card. ``timings`` as in :func:`run_vps_inference`, without
    ``segments_s``; ``logits_masks_fn`` as in :func:`run_vis_inference`."""
    with torch.inference_mode():
        for sample, logits, aux, chunks, padded in _task_chunks(cfg, model, loader, timings,
                                                                logits_masks_fn):
            t1 = time.perf_counter()
            h, w = [int(v) for v in sample["image_size"]]
            out_size = (int(sample["height"]), int(sample["width"]))
            sem = torch.cat([
                semantic_inference(logits, chunk, img_size=(h, w), output_size=out_size,
                                   padded_size=padded, aux_pred_cls=aux).to(torch.uint8)
                for chunk in chunks]).cpu().numpy()
            t2 = time.perf_counter()
            evaluator.process(sample.get("video_id", 0), sample["file_names"], sem)
            if timings is not None:
                t3 = time.perf_counter()
                timings["post_s"] = timings.get("post_s", 0.0) + t3 - t1
                timings["png_s"] = timings.get("png_s", 0.0) + t3 - t2
