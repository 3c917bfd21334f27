"""VIS inference loop: windowed streaming eval over whole videos.

Counterpart: ``dvis_plus_tpu/engine/inference.py`` (``resolve_window_size``
:27, ``eval_mask_budget_bytes`` :45, ``paged_inference_video`` :132,
``run_vis_inference`` :274, ``_online_video`` :620-777 with its online and
offline halves). Signatures are the JAX ones without ``params``: the module
holds its weights.

Frames are cut into windows of ``test.window_size`` (the tail window is
padded by repeating the last frame), the tracker carry streams across
windows, and each video's top-K masks are upsampled a chunk of frames at a
time, thresholded and bit-packed on the device (``download="packed"``), so
only packed bits reach the host. The JAX package's ``runs`` download (RLE
run boundaries extracted on the device) is not ported yet.

Offline (``dvis_offline``): the refiner's embed pass runs once over the
video's true length T. The JAX eval loop pads the time axis to a power-of-two
window count by replicating the last real frame and masks the padding
(``_bucket_windows`` :491, ``_pad_time_replicate`` :502) only to bound its
per-shape compiles; eager PyTorch has none, and the two give the same
real-frame outputs (``tests/test_torch_dvis_offline.py``).
"""
from __future__ import annotations

import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from dvis_plus_tpu_torch.config import check_supported
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
    if download not in (None, "packed"):  # config.SUPPORTED's test.mask_download row
        raise NotImplementedError(
            f"mask download {download!r} is not ported (ROADMAP A6); use 'packed'")
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
    """DVIS online: the tracker carry streams across windows; offline: the
    window outputs accumulate, then one refiner pass over the whole video.
    images (T, H, W, 3) normalized numpy. Returns (class logits (Q, K+1),
    masks (Q, T, H4, W4) on the device or paged to host fp16, aux logits
    (Q, K+1) or None)."""
    dev = next(model.parameters()).device
    td = cfg.model.transformer_decoder
    C2 = td.hidden_dim * (2 if td.reid_branch else 1)
    state = init_tracker_state(1, td.num_queries, C2, dtype_of(cfg.model.compute_dtype), dev)

    T = images.shape[0]
    n_windows = (T + W_sz - 1) // W_sz
    images = _pad_to(images, n_windows * W_sz)
    Him, Wim = images.shape[1:3]

    def window(i):
        chunk = torch.from_numpy(np.ascontiguousarray(images[i * W_sz : (i + 1) * W_sz]))
        return chunk.to(dev).permute(0, 3, 1, 2)[None]  # (1, W_sz, 3, H, W)

    if cfg.model.meta_architecture != "dvis_offline":
        # beyond the memory budget each window's masks page to host fp16
        mask_bytes = n_windows * W_sz * td.num_queries * (Him // 4) * (Wim // 4) * 4
        page_to_host = mask_bytes > eval_mask_budget_bytes(cfg)
        logits_l, masks_l = [], []
        for i in range(n_windows):
            _, track_out, state = model(window(i), state=state)
            logits_l.append(track_out["pred_logits"][0])
            mk = track_out["pred_masks"][0]
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
        lg, inst, frame, mf, state = model.online_step(window(i), state)
        online_logits_l.append(lg[0])
        inst_l.append(inst)
        frame_l.append(frame)
        mf_l.append(mf if keep_on_device else mf.cpu())
    online_logits = torch.cat(online_logits_l, dim=0)[:T]  # (T, Q, K+1)
    inst = torch.cat(inst_l, dim=1)[:, :T]
    frame = torch.cat(frame_l, dim=1)[:, :T]

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


def run_vis_inference(cfg, model, loader: Iterator[dict], evaluator,
                      timings: Optional[dict] = None):
    """VIS eval loop: windows -> post-processing -> top-K packed masks ->
    ``evaluator.process`` per video. ``timings`` (optional dict) accumulates
    ``model_s`` (window forwards, synchronized) and ``post_s`` (top-K,
    upsample, packed download, evaluator rows) in wall seconds. A setting
    the port cannot honour raises ``NotImplementedError``
    (``config.check_supported``)."""
    check_supported(cfg)
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
