"""VIS inference loop: windowed streaming eval over whole videos.

Counterpart: ``dvis_plus_tpu/engine/inference.py`` (``resolve_window_size``
:27, ``paged_inference_video`` :132, ``run_vis_inference`` :274, the online
half of ``_online_video`` :620-684). Signatures are the JAX ones without
``params``: the module holds its weights.

Frames are cut into windows of ``test.window_size`` (the tail window is
padded by repeating the last frame), the tracker carry streams across
windows, and each video's top-K masks are upsampled a chunk of frames at a
time, thresholded and bit-packed on the device (``download="packed"``), so
only packed bits reach the host. The JAX package's ``runs`` download (RLE
run boundaries extracted on the device) is not ported yet.
"""
from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np
import torch

from dvis_plus_tpu_torch.models.meta.dvis_online import online_post_processing
from dvis_plus_tpu_torch.models.meta.minvis import topk_select, upsample_masks
from dvis_plus_tpu_torch.models.segmenter.pixel_decoder import dtype_of
from dvis_plus_tpu_torch.models.tracker.referring_tracker import init_tracker_state
from dvis_plus_tpu_torch.utils.rle import PackedMasks


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
    time are gathered, upsampled, thresholded and bit-packed on the mask's
    device and copied to the host. Returns (scores, labels, masks) where
    masks is a :class:`~dvis_plus_tpu_torch.utils.rle.PackedMasks` (``download`` /
    ``packed`` given) or a (n, T, H, W) bool array (legacy default).
    ``k_col`` belongs to the ``runs`` download, which is not ported."""
    if download not in (None, "packed"):
        raise NotImplementedError(f"mask download {download!r} is not ported; use 'packed'")
    want_array = download is None and not packed
    scores, labels, queries = topk_select(mask_cls, topk, aux_pred_cls)
    dev = mask_cls.device
    T = mask_pred.shape[1]
    oh, ow = int(output_size[0]), int(output_size[1])
    sizes = (tuple(img_size), (oh, ow), tuple(padded_size))
    q = queries.to(mask_pred.device)
    bits = np.zeros((int(scores.shape[0]), T, oh, (ow + 7) // 8), np.uint8)
    for s0 in range(0, T, chunk):
        sel = mask_pred[q, s0 : s0 + chunk].to(dev, torch.float32)
        bits[:, s0 : s0 + chunk] = _upsample_pack(sel, *sizes).cpu().numpy()
    out = PackedMasks(bits, oh, ow)
    return scores, labels, out.unpack() if want_array else out


def _pad_to(images: np.ndarray, pad_T: int) -> np.ndarray:
    T = images.shape[0]
    if T == pad_T:
        return images
    return np.concatenate([images, np.repeat(images[-1:], pad_T - T, axis=0)], axis=0)


def _online_video(cfg, model, images: np.ndarray, W_sz: int):
    """DVIS online: the tracker carry streams across windows. images
    (T, H, W, 3) normalized numpy. Returns (mean logits (Q, K+1), masks
    (Q, T, H4, W4), None)."""
    dev = next(model.parameters()).device
    td = cfg.model.transformer_decoder
    C2 = td.hidden_dim * (2 if td.reid_branch else 1)
    state = init_tracker_state(1, td.num_queries, C2, dtype_of(cfg.model.compute_dtype), dev)

    T = images.shape[0]
    n_windows = (T + W_sz - 1) // W_sz
    images = _pad_to(images, n_windows * W_sz)
    # beyond the memory budget each window's masks page to host fp16
    Him, Wim = images.shape[1:3]
    mask_bytes = n_windows * W_sz * td.num_queries * (Him // 4) * (Wim // 4) * 4
    page_to_host = mask_bytes > float(cfg.test.offline_mf_budget_gb) * 1e9

    logits_l, masks_l = [], []
    for i in range(n_windows):
        chunk = torch.from_numpy(np.ascontiguousarray(images[i * W_sz : (i + 1) * W_sz]))
        chunk = chunk.to(dev).permute(0, 3, 1, 2)[None]  # (1, W_sz, 3, H, W)
        _, track_out, state = model(chunk, state=state)
        logits_l.append(track_out["pred_logits"][0])
        mk = track_out["pred_masks"][0]
        masks_l.append(mk.to("cpu", torch.float16) if page_to_host else mk)
    logits = torch.cat(logits_l, dim=0)[:T]  # (T, Q, K+1)
    masks = torch.cat(masks_l, dim=1)[:, :T]  # (Q, T, H4, W4)
    return online_post_processing(logits.float()), masks, None


def run_vis_inference(cfg, model, loader: Iterator[dict], evaluator,
                      timings: Optional[dict] = None):
    """VIS eval loop: windows -> post-processing -> top-K packed masks ->
    ``evaluator.process`` per video. ``timings`` (optional dict) accumulates
    ``model_s`` (window forwards, synchronized) and ``post_s`` (top-K,
    upsample, packed download, evaluator rows) in wall seconds."""
    arch = cfg.model.meta_architecture
    if arch != "dvis_online":
        raise NotImplementedError(f"meta_architecture {arch!r} is not ported yet")
    W_sz = resolve_window_size(cfg)
    dev = next(model.parameters()).device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        for sample in loader:
            images = sample["images"]  # (T, H, W, 3) numpy
            H, W = images.shape[1:3]
            t0 = time.perf_counter()
            logits, masks, aux = _online_video(cfg, model, images, W_sz)
            sync()
            t1 = time.perf_counter()
            h, w = [int(v) for v in sample["image_size"]]
            scores, labels, out_masks = paged_inference_video(
                logits, masks, img_size=(h, w),
                output_size=(int(sample["height"]), int(sample["width"])),
                padded_size=(H, W), topk=cfg.test.max_num, aux_pred_cls=aux,
                chunk=W_sz, download="packed",
            )
            evaluator.process(
                sample.get("video_id", 0),
                {
                    "pred_scores": scores.cpu().tolist(),
                    "pred_labels": labels.cpu().tolist(),
                    "pred_masks": out_masks,
                },
            )
            if timings is not None:
                timings["model_s"] = timings.get("model_s", 0.0) + t1 - t0
                timings["post_s"] = timings.get("post_s", 0.0) + time.perf_counter() - t1
