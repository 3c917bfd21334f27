"""DVIS++ offline (segmenter, referring tracker, temporal refiner) in an
``eval_stream`` cell.

Captured of the program: the tracker's output queries and class logits of
every window (a forward hook), and the refiner's video class logits (its
``embed_pass``). The reference is ``reference/dvis.py`` run by
``reference/video.py::vss_video``; the operations are counted on it
(``work/flops.py``).
"""
from __future__ import annotations

from typing import Dict, List

import torch


def capture(model, cap):
    def tracker_hook(_mod, _args, output):
        cap.append("tracker_embeds", output[0]["pred_embds"][0])
        cap.append("tracker_logits", output[0]["pred_logits"][0])

    handle = model.tracker.register_forward_hook(tracker_hook)
    embed_pass = model.refiner.embed_pass

    def refiner_embed_pass(*a, **k):
        result = embed_pass(*a, **k)
        cap.put("refiner_logits", result["pred_logits"][0])
        return result

    model.refiner.embed_pass = refiner_embed_pass

    def undo():
        handle.remove()
        del model.refiner.embed_pass

    return undo


def spans(model, spans) -> None:
    spans.module("backbone", model.backbone)
    spans.module("pixel_decoder", model.sem_seg_head.pixel_decoder)
    spans.module("predictor", model.sem_seg_head.predictor)
    spans.module("tracker", model.tracker)
    spans.method("refiner", model.refiner, "embed_pass")
    spans.method("refiner_masks", model.refiner, "mask_window")


@torch.no_grad()
def reference_outputs(ns, seed: int, gains, videos: List[Dict], sample_idx: torch.Tensor, device,
                      precision: str = "fp32", candidates: List[Dict[str, torch.Tensor]] = None
                      ) -> List[Dict]:
    """The reference's outputs of ``videos`` ([{"file_names": [...]}, ...]), on
    ``device``, fp32 (TF32 off) or the fp8 control; moved to the CPU. ``ns``:
    the configuration as namespaces (``bench/portcfg.py``); ``candidates``:
    per video {name: (T, H, W) class map} whose map numbers the pass measures."""
    from port_bench.bench.weights import build_on
    from port_bench.reference import layers
    from port_bench.reference.dvis import DVISOfflineReference
    from port_bench.reference.video import read_video, vss_video

    mcfg, inp = ns.model, ns.input
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers.set_precision(precision)
    try:
        model = build_on(lambda: DVISOfflineReference(mcfg), device, seed, gains)
        outs = []
        for n, v in enumerate(videos):
            vid = read_video(v["file_names"], inp.min_size_test, inp.max_size_test,
                             mcfg.pixel_mean, mcfg.pixel_std, mcfg.size_divisibility)
            images = torch.from_numpy(vid["images"]).to(device)
            r = vss_video(model, images, vid["image_size"], (vid["height"], vid["width"]),
                          ns.test.window_size, sample_idx, candidates[n] if candidates else None)
            outs.append({k: t.cpu() for k, t in r.items()})
            del images, r
        del model
        return outs
    finally:
        layers.set_precision("fp32")
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def video_flops(mcfg, T: int, padded: tuple, image_size: tuple, output_size: tuple,
                window: int, cache_path: str) -> float:
    """Operations of DVIS++ offline over a video of T frames on the padded
    canvas, as the reference's ``vss_video`` computes it: one window's
    segmenter and tracker times the windows, then the refiner over the T
    frames, its masks and the class maps (the kept mask samples excluded)."""
    from port_bench.reference.dvis import DVISOfflineReference
    from port_bench.reference.tracker import init_tracker_state
    from port_bench.reference.video import class_probs, semantic_map
    from port_bench.work.flops import cached, count

    with torch.device("meta"):
        model = DVISOfflineReference(mcfg).requires_grad_(False)
    td = mcfg.transformer_decoder
    Q, C2, Cm = td.num_queries, td.hidden_dim * (2 if td.reid_branch else 1), td.hidden_dim
    H4, W4 = padded[0] // 4, padded[1] // 4
    shape = f"{padded[0]}x{padded[1]}"

    def one_window():
        frames = torch.empty(1, window, 3, *padded, device="meta")
        state = init_tracker_state(1, Q, C2, torch.float32, "meta")
        with torch.no_grad():
            return count(model.online_step, frames, state)

    def tail():
        inst = torch.empty(1, T, Q, C2, device="meta")

        def run():
            with torch.no_grad():
                r = model.refiner.embed_pass(inst, inst)
                probs = class_probs(r["pred_logits"][0], r["pred_logits"][0])
                for t0 in range(0, T, window):
                    t1 = min(t0 + window, T)
                    mf = torch.empty(1, t1 - t0, Cm, H4, W4, device="meta")
                    mw = model.refiner.mask_window(r["mask_embed"][:, t0:t1], mf)[0]
                    semantic_map(probs, mw, image_size, output_size, padded)

        return count(run)

    n_win = -(-T // window)
    win = cached(cache_path, f"window:{shape}:w{window}", one_window)
    rest = cached(cache_path, f"tail:T{T}:{shape}:{image_size[0]}x{image_size[1]}:"
                              f"{output_size[0]}x{output_size[1]}:w{window}", tail)
    return n_win * win + rest
