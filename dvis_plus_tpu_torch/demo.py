"""Video segmentation demo of the port: run a model on a folder of frames and
write colour-overlaid visualizations (the counterpart of ``demo_video.py``):

    python -m dvis_plus_tpu_torch.demo --config-file configs/dvis/dvis_online_r50_ytvis19.yaml \\
        --input frames_dir --output out_dir [--windows-size 10] [--chunk-size 0] \\
        [--confidence-threshold 0.3] [--vocabulary "cat,dog"] \\
        [--thing-classes "cat,dog" --stuff-classes "sky" --merge] \\
        [--clip-weights <open_clip state dict> --bpe <merges .txt.gz> | --random-text] \\
        [--device cuda|cpu] [weights=<state_dict .pth/.npz>] [key.path=value ...]

The flags are ``demo_video.py``'s, plus ``--device``: ``cuda`` (the default)
raises when no card is present; only ``--device cpu`` runs on the CPU.
Without ``weights=`` the model keeps its random initialization from ``seed``.

What each mode runs, as ``demo_video.py`` does (:78-290):

- whole video: every frame through the eval loop's per-video forward
  (``engine/inference.py``: ``_minvis_video`` for ``minvis`` and ``ctvis``,
  ``_online_video`` for ``dvis_online`` and ``dvis_offline``), then the
  one-shot top-K of ``models/meta/minvis.py::inference_video``
  (``test.max_num`` instances, masks at the frames' size);
- ``--chunk-size N`` with ``dvis_online`` (closed vocabulary): chunks of
  max(N, window) frames, the tracker's carry (``init_tracker_state``) kept
  from chunk to chunk (the reference ``demo_long_video.py`` keep protocol),
  each chunk's top-K taken on its own. With any other architecture, or an
  open-vocabulary model, ``demo_video.py`` ignores ``--chunk-size`` and runs
  the whole video: so does this demo (it logs that it does);
- open vocabulary (``model.ov.enabled``, or ``--thing-classes`` /
  ``--stuff-classes``, which enable it): ``cli_ov``'s model and text encoder
  (``--clip-weights`` and ``--bpe``, or ``--random-text``); the classes are
  the custom lists, with ``--merge`` (or without a custom list) after the
  first test set's vocabulary (``cli_ov.vocabulary_for``); every class is
  taken as seen in training (``geometric_ensemble_alpha``); the forward is
  ``engine/ov_inference.py``'s (MinVIS, DVIS++ online or offline).

``demo_video.py`` cannot run ``maskformer``, ``video_maskformer``,
``daq_online`` or ``daq_offline`` (its window function hands the model a
tracker carry those models do not take) nor an open-vocabulary ``ctvis``
(it sends every open-vocabulary architecture but MinVIS and DVIS++ online
to the offline forward): this demo refuses them, naming the architecture.

The overlays are ``demo_video.py``'s: each instance scoring at least
``--confidence-threshold`` blended 0.55 / 0.45 with its colour (seeded by its
index), its class name and score written above its top-left pixel; JPEG
under the frame's own file name. The class names are the first registered
test set's (``demo_video.py`` registers none, so in practice the indices),
``--vocabulary``'s, or the open-vocabulary classes' first synonyms.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

logger = logging.getLogger("dvis_plus_tpu_torch.demo")

DEMO_ARCHS = ("minvis", "ctvis", "dvis_online", "dvis_offline")


def color_for(i: int) -> np.ndarray:
    rng = np.random.RandomState(i * 7919 + 13)
    return rng.randint(64, 255, (3,), dtype=np.int32)


def visualize(frame_rgb, masks, scores, labels, ids, class_names, thr):
    """One frame's overlay (uint8 RGB), ``demo_video.py::visualize``."""
    import cv2

    vis = frame_rgb.astype(np.float32)
    texts = []
    for m, s, lab, i in zip(masks, scores, labels, ids):
        if s < thr:
            continue
        color = color_for(int(i)).astype(np.float32)
        vis = np.where(m[..., None], 0.55 * vis + 0.45 * color, vis)
        ys, xs = np.nonzero(m)
        if len(ys):
            name = class_names[lab] if lab < len(class_names) else str(lab)
            texts.append((f"{name} {s:.2f}", (int(xs.min()), max(int(ys.min()) - 4, 10)),
                          tuple(int(c) for c in color)))
    vis = vis.astype(np.uint8)  # cv2.putText takes uint8
    for txt, org, color in texts:
        cv2.putText(vis, txt, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return vis


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--input", required=True, help="directory of frames")
    parser.add_argument("--output", required=True)
    parser.add_argument("--windows-size", type=int, default=None)
    parser.add_argument("--chunk-size", type=int, default=0,
                        help="long-video mode (dvis_online): frames per chunk, the tracker's carry "
                             "kept across chunks")
    parser.add_argument("--confidence-threshold", type=float, default=0.3)
    parser.add_argument("--vocabulary", default=None, help="comma-separated class names")
    parser.add_argument("--thing-classes", default=None,
                        help="open vocabulary: comma-separated custom thing classes")
    parser.add_argument("--stuff-classes", default=None,
                        help="open vocabulary: comma-separated custom stuff classes")
    parser.add_argument("--merge", action="store_true",
                        help="open vocabulary: the custom classes after the test set's vocabulary")
    parser.add_argument("--clip-weights", default=os.environ.get("DVIS_CLIP_WEIGHTS", ""))
    parser.add_argument("--bpe", default=os.environ.get("DVIS_CLIP_BPE", ""))
    parser.add_argument("--random-text", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default) raises without a card; cpu must be asked for")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def _ov_classes(cfg, args):
    """The open-vocabulary classes (synonym lists), as ``demo_video.py``."""
    from dvis_plus_tpu_torch.cli_ov import vocabulary_for

    classes = []
    if args.merge or not (args.thing_classes or args.stuff_classes):
        try:
            classes = list(vocabulary_for(cfg.datasets.test[0]))
        except Exception:  # noqa: BLE001 — no vocabulary for the set: the custom lists alone
            classes = []
    for arg in (args.thing_classes, args.stuff_classes):
        if arg:
            classes += [[c.strip()] for c in arg.split(",") if c.strip()]
    if not classes:
        raise ValueError("the open-vocabulary demo needs --thing-classes / --stuff-classes or a "
                         "test set with a vocabulary")
    return classes


def _class_names(cfg, args, ov_classes):
    from dvis_plus_tpu_torch.data.catalog import get_metadata, is_registered

    names = None
    for ds in cfg.datasets.test:
        if is_registered(ds):
            names = get_metadata(ds).thing_classes
            break
    if args.vocabulary:
        names = [c.strip() for c in args.vocabulary.split(",")]
    if ov_classes is not None:
        names = [syns[0] for syns in ov_classes]
    return names or [str(i) for i in range(cfg.model.num_classes)]


def _write(frame_files, out_dir, res, names, thr, offset=0) -> int:
    """The overlays of ``res`` (an ``inference_video`` result) for
    ``frame_files[offset:]``; returns how many were written."""
    import cv2

    scores = res.scores.cpu().numpy()
    labels = res.labels.cpu().numpy()
    masks = res.masks.cpu().numpy()
    n = masks.shape[1]
    for t in range(n):
        path = frame_files[offset + t]
        frame = cv2.imread(path)[:, :, ::-1]
        vis = visualize(frame, masks[:, t], scores, labels, np.arange(len(scores)), names, thr)
        cv2.imwrite(os.path.join(out_dir, os.path.basename(path)), vis[:, :, ::-1])
    return n


def _chunked(cfg, model, mapper, record, frame_files, args, names, H0, W0) -> int:
    """The long-video mode (``demo_video.py`` :158-225): the tracker's carry
    across chunks, one top-K a chunk."""
    from dvis_plus_tpu_torch.engine.inference import _frames, _pad_to, _tracker_window
    from dvis_plus_tpu_torch.models.meta.dvis_online import online_post_processing
    from dvis_plus_tpu_torch.models.meta.minvis import inference_video
    from dvis_plus_tpu_torch.models.segmenter.pixel_decoder import dtype_of
    from dvis_plus_tpu_torch.models.tracker.referring_tracker import init_tracker_state

    dev = next(model.parameters()).device
    W_sz = cfg.test.window_size
    td = cfg.model.transformer_decoder
    C2 = td.hidden_dim * (2 if td.reid_branch else 1)
    state = init_tracker_state(1, td.num_queries, C2, dtype_of(cfg.model.compute_dtype), dev)
    chunk = max(args.chunk_size, W_sz)
    written = 0
    for start in range(0, len(frame_files), chunk):
        files = frame_files[start : start + chunk]
        sample = mapper(dict(record, file_names=files, length=len(files)), seed=0)
        images = sample["images"]
        Tc = images.shape[0]
        n_w = (Tc + W_sz - 1) // W_sz
        padded = _pad_to(images, n_w * W_sz)
        lg_l, mk_l = [], []
        for i in range(n_w):
            frames = _frames(padded[i * W_sz : (i + 1) * W_sz], dev, cfg, sample["image_size"],
                             min(W_sz, Tc - i * W_sz))
            lg, mk, state = _tracker_window(model, frames, state)
            lg_l.append(lg)
            mk_l.append(mk)
        logits = online_post_processing(torch.cat(lg_l)[:Tc].float())
        masks = torch.cat(mk_l, dim=1)[:, :Tc]
        h, w = [int(v) for v in sample["image_size"]]
        res = inference_video(logits, masks, img_size=(h, w), output_size=(H0, W0),
                              padded_size=images.shape[1:3], topk=cfg.test.max_num)
        written += _write(frame_files, args.output, res, names, args.confidence_threshold, start)
    return written


def main(argv=None) -> dict:
    """Run the demo; returns {frames, overlays, seconds, fps, device,
    chunked}."""
    import cv2

    from dvis_plus_tpu_torch.cli import build_model
    from dvis_plus_tpu_torch.config import check_supported, load_config, ov_arch
    from dvis_plus_tpu_torch.core.checkpoint import load_weights
    from dvis_plus_tpu_torch.data.mapper import YTVISDatasetMapper

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = load_config(args.config_file, args.opts)
    if args.windows_size:
        cfg.test.window_size = args.windows_size
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    dev = torch.device(args.device)

    ov_mode = bool(cfg.model.ov.enabled or args.thing_classes or args.stuff_classes)
    ov_classes = None
    if ov_mode:
        from dvis_plus_tpu_torch.cli_ov import build_ov_model, make_text_encoder
        from dvis_plus_tpu_torch.models.ov.text import TextClassifierCache

        cfg.model.ov.enabled = True
        cfg.model.meta_architecture = ov_arch(cfg)
        if cfg.model.meta_architecture == "ctvis":
            raise ValueError("demo_video.py runs no open-vocabulary ctvis model (it sends it to the "
                             "offline forward); use minvis, dvis_online or dvis_offline")
        check_supported(cfg)
        torch.manual_seed(cfg.seed)
        model = build_ov_model(cfg)
        encode_fn = make_text_encoder(cfg, args, dev)
        ov_classes = _ov_classes(cfg, args)
        tc, nt = TextClassifierCache(encode_fn).get("demo", ov_classes)
    else:
        check_supported(cfg)
        if cfg.model.meta_architecture not in DEMO_ARCHS:
            raise ValueError(f"demo_video.py cannot run model.meta_architecture="
                             f"{cfg.model.meta_architecture!r} (its window function hands the model "
                             f"a tracker carry); the demo runs {', '.join(DEMO_ARCHS)}")
        torch.manual_seed(cfg.seed)
        model = build_model(cfg.model)
    if cfg.weights:
        load_weights(model, cfg.weights)
    model = model.to(dev).eval()

    frame_files = sorted(os.path.join(args.input, f) for f in os.listdir(args.input)
                         if f.lower().endswith((".jpg", ".png", ".jpeg")))
    if not frame_files:
        raise FileNotFoundError(f"no frames in {args.input}")
    H0, W0 = cv2.imread(frame_files[0]).shape[:2]
    record = {"file_names": frame_files, "height": H0, "width": W0, "length": len(frame_files),
              "video_id": 0}
    mapper = YTVISDatasetMapper(cfg, is_train=False)
    names = _class_names(cfg, args, ov_classes)
    os.makedirs(args.output, exist_ok=True)
    arch = cfg.model.meta_architecture
    chunked = bool(args.chunk_size) and arch == "dvis_online" and not ov_mode
    if args.chunk_size and not chunked:
        logger.info("--chunk-size applies to closed-vocabulary dvis_online alone (as in "
                    "demo_video.py): %s runs the whole video", arch)

    t0 = time.perf_counter()
    with torch.inference_mode():
        if chunked:
            written = _chunked(cfg, model, mapper, record, frame_files, args, names, H0, W0)
        else:
            written = _whole(cfg, model, mapper, record, frame_files, args, names, H0, W0,
                             (tc, nt) if ov_mode else None)
    dt = time.perf_counter() - t0
    n = len(frame_files)
    print(f"{n} frames in {dt:.1f}s ({n / dt:.2f} fps)" + (" chunked" if chunked else ""))
    print(f"wrote {written} visualizations to {args.output}")
    return {"frames": n, "overlays": written, "seconds": dt, "fps": n / dt, "device": str(dev),
            "chunked": chunked}


def _whole(cfg, model, mapper, record, frame_files, args, names, H0, W0, classifier) -> int:
    """The whole-video mode: the forward of the eval loop, one top-K."""
    from dvis_plus_tpu_torch.engine.inference import _minvis_video, _online_video
    from dvis_plus_tpu_torch.engine.ov_inference import ov_video_logits_masks_fn
    from dvis_plus_tpu_torch.models.meta.minvis import inference_video

    sample = mapper(record, seed=0)
    images = sample["images"]
    W_sz = cfg.test.window_size
    aux = None
    if classifier is not None:
        tc, nt = classifier
        fn = ov_video_logits_masks_fn(cfg, model, tc, nt, np.ones((len(nt) - 1,), np.float32))
        logits, masks = fn(images, sample["image_size"])
    elif cfg.model.meta_architecture in ("minvis", "ctvis"):
        logits, masks, aux = _minvis_video(cfg, model, images, W_sz, image_size=sample["image_size"])
    else:
        logits, masks, aux = _online_video(cfg, model, images, W_sz, image_size=sample["image_size"])
    h, w = [int(v) for v in sample["image_size"]]
    res = inference_video(logits, masks[:, : len(frame_files)], img_size=(h, w),
                          output_size=(H0, W0), padded_size=images.shape[1:3],
                          topk=cfg.test.max_num, aux_pred_cls=aux)
    return _write(frame_files, args.output, res, names, args.confidence_threshold)


if __name__ == "__main__":
    main()
