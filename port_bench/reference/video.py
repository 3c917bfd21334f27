"""The plain reference's video semantic segmentation, and its reading of the frames.

``read_video`` maps JPEG frames as the VSS test loader is specified to: every
frame read as RGB, resized so that its shorter edge is ``min_size_test`` (the
longer at most ``max_size_test``), normalized by the pixel mean and std, and
zero-padded at the bottom and the right to a multiple of the size
divisibility. ``vss_video`` runs DVIS++ offline over it as the eval loop is
specified to: windows of ``test.window_size`` frames (the last one padded by
repeating the last frame) through the segmenter and the tracker with the
tracker's state carried across windows, one refiner pass over the video's true
length, then a window at a time the refined masks and the per-pixel argmax of
``sum_q p(class | q) * sigmoid(mask_q)``, where p takes the element-wise max
of the refiner's and the tracker's time-averaged class softmax.

It returns what the benchmark compares with the program's outputs: the
tracker's embeds and logits of every window, the refiner's video logits, the
time-averaged tracker logits, the refined mask logits at given pixels of the
stride-4 grid, the (T, H, W) class map, and how far given class maps
depart from it.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.tracker import init_tracker_state


def resize_shortest_edge(h: int, w: int, size: int, max_size: int) -> Tuple[int, int]:
    scale = size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(round(h * scale)), int(round(w * scale))


def read_video(file_names: Sequence[str], min_size: int, max_size: int, pixel_mean, pixel_std,
               divisibility: int) -> Dict[str, object]:
    """-> {"images": (T, Hp, Wp, 3) float32, "image_size": (h, w), "height", "width"}."""
    import cv2

    frames = [cv2.imread(f, cv2.IMREAD_COLOR)[:, :, ::-1] for f in file_names]
    H0, W0 = frames[0].shape[:2]
    h, w = resize_shortest_edge(H0, W0, min_size, max_size)
    if (h, w) != (H0, W0):
        frames = [cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR) for f in frames]
    Hp, Wp = -(-h // divisibility) * divisibility, -(-w // divisibility) * divisibility
    images = np.zeros((len(frames), Hp, Wp, 3), np.float32)
    mean, std = np.asarray(pixel_mean, np.float32), np.asarray(pixel_std, np.float32)
    for t, f in enumerate(frames):
        images[t, :h, :w] = (f.astype(np.float32) - mean) / std
    return {"images": images, "image_size": (h, w), "height": H0, "width": W0}


def class_probs(mask_cls: torch.Tensor, aux_cls: torch.Tensor = None) -> torch.Tensor:
    """(Q, K) class probabilities: the video's class softmax, its first K
    columns maxed with the tracker's time-averaged one where given, no-object
    column dropped."""
    probs = mask_cls.float().softmax(-1)[:, :-1]
    if aux_cls is None:
        return probs
    return torch.maximum(probs, aux_cls.float().softmax(-1)[:, :-1])


MARGIN = 0.20  # a clear lead: the best class's score over the second's, as a share of the best


def semantic_map(probs: torch.Tensor, mask_logits: torch.Tensor, img_size, output_size,
                 padded_size, candidates=None):
    """probs (Q, K), mask logits (Q, t, H4, W4) -> (t, out_h, out_w) class ids:
    logits resized to the padded input, cropped, sigmoid, resized to the output
    (antialiased where it shrinks), then the argmax over classes of the scores
    ``S_c = sum_q p_qc m_q``. ``candidates``: {name: (t, out_h, out_w) class
    ids} held against the scores: the widest gap, over the pixels, by which
    the score of the candidate's class lies below the best, as a share of the
    best (``gap``); and, at the pixels where the best class leads the second
    by at least ``MARGIN`` of the best, how many there are (``clear``) and at
    how many the candidate's class differs (``wrong``). Returns (class ids,
    {name: {number: 0-d tensor}})."""
    m = F.interpolate(mask_logits.float(), size=tuple(padded_size), mode="bilinear",
                      align_corners=False)
    m = m[:, :, : img_size[0], : img_size[1]].sigmoid()
    m = F.interpolate(m, size=tuple(output_size), mode="bilinear", align_corners=False,
                      antialias=True)
    maps, stats = [], {}
    for t in range(m.shape[1]):
        score = torch.einsum("qc,qhw->chw", probs, m[:, t])
        maps.append(score.argmax(0))
        if not candidates:
            continue
        top2 = score.topk(2, dim=0).values
        best = top2[0].clamp(min=1e-30)
        clear = (top2[0] - top2[1]) / best >= MARGIN
        for k, cand in candidates.items():
            c = cand[t].to(score.device).long()
            chosen = score.gather(0, c[None])[0]
            frame = {"gap": ((top2[0] - chosen) / best).amax(), "clear": clear.sum(),
                     "wrong": ((c != maps[-1]) & clear).sum()}
            stats[k] = merge_stats(stats.get(k), frame)
    return torch.stack(maps), stats


def merge_stats(a, b):
    """Two spans' map numbers of one candidate: the counts add, the gap takes the larger."""
    if a is None:
        return b
    return {"gap": torch.maximum(a["gap"], b["gap"]), "clear": a["clear"] + b["clear"],
            "wrong": a["wrong"] + b["wrong"]}


@torch.no_grad()
def vss_video(model, images: torch.Tensor, image_size, output_size, window: int,
              sample_idx: torch.Tensor, candidates=None) -> Dict[str, torch.Tensor]:
    """``model``: a ``DVISOfflineReference``; ``images`` (T, Hp, Wp, 3)
    normalized on the model's device (``read_video``'s); ``sample_idx``: flat
    indices into the stride-4 grid where the refined mask logits are kept;
    ``candidates``: {name: (T, H, W) class ids} whose map numbers
    (``semantic_map``) are returned under ``map:<name>:<number>``: the widest
    score gap, and the share of the video's pixels of a clear lead whose
    class differs. Returns device tensors."""
    device = images.device
    T = images.shape[0]
    n_win = -(-T // window)
    if n_win * window > T:
        images = torch.cat([images, images[-1:].expand(n_win * window - T, *images.shape[1:])])
    frames = images.permute(0, 3, 1, 2)
    C2 = model.tracker.decoder_norm.normalized_shape[0]
    Q = model.sem_seg_head.predictor.query_feat.weight.shape[0]
    state = init_tracker_state(1, Q, C2, torch.float32, device)
    embeds, logits, inst, frame_nn, mfs = [], [], [], [], []
    for i in range(n_win):
        track, fnn, mf, state = model.online_step(frames[i * window : (i + 1) * window][None], state)
        embeds.append(track["pred_embds"][0])
        logits.append(track["pred_logits"][0])
        inst.append(track["pred_embds"])
        frame_nn.append(fnn)
        mfs.append(mf)
    online_logits = torch.cat(logits)[:T]
    r = model.refiner.embed_pass(torch.cat(inst, dim=1)[:, :T], torch.cat(frame_nn, dim=1)[:, :T])
    r_logits, membd = r["pred_logits"][0], r["mask_embed"]
    aux = online_logits.float().mean(dim=0)
    probs = class_probs(r_logits, aux)
    Hp, Wp = frames.shape[-2:]
    maps, samples, stats = [], [], {}
    for i in range(n_win):
        t0, t1 = i * window, min((i + 1) * window, T)
        if t0 >= T:
            break
        mw = model.refiner.mask_window(membd[:, t0:t1], mfs[i][:, : t1 - t0])[0]  # (Q, tw, H4, W4)
        samples.append(mw.flatten(2)[:, :, sample_idx.to(device)])
        cand = {k: v[t0:t1] for k, v in (candidates or {}).items()}
        cmap, st = semantic_map(probs, mw, image_size, output_size, (Hp, Wp), cand)
        maps.append(cmap)
        stats = {k: merge_stats(stats.get(k), v) for k, v in st.items()}
    out = {"tracker_embeds": torch.cat(embeds).float(), "tracker_logits": torch.cat(logits).float(),
           "refiner_logits": r_logits.float(), "aux_logits": aux,
           "mask_samples": torch.cat(samples, dim=1).float(), "class_map": torch.cat(maps)}
    for k, st in stats.items():
        out[f"map:{k}:map_score_gap"] = st["gap"]
        out[f"map:{k}:map_clear_mismatch"] = st["wrong"] / st["clear"].clamp(min=1)
    return out
