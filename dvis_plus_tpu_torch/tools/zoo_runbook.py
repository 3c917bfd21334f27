"""One-command real-weights runbook of the port (zoo ``.pth`` -> verdict):

    python -m dvis_plus_tpu_torch.tools.zoo_runbook \\
        --config-file configs/dvis/dvis_online_r50_ytvis19.yaml \\
        --weights /path/to/zoo_row.pth [--ref-results /path/to/reference_results.json] \\
        [--device cuda|cpu] [key.path=value ...]

Counterpart: ``tools/zoo_runbook.py`` of the JAX package (``stage_convert``
:53, ``stage_eval`` :88, ``stage_diff`` :100, ``parity_check.py::
coverage_report`` :326), with the same flags plus ``--device``. Each stage
prints a ``[runbook]`` line; any failure exits non-zero.

1. convert: the ``.pth`` (a state dict in the reference checkpoints' key
   space, which the port's modules carry) loaded into the port's model of
   the configuration through ``core/checkpoint.py::load_weights``, with a
   coverage report: keys filled, keys of another shape (mismatched), the
   model's keys the file lacks (left at init), the file's keys the model
   has no use for (extra). It fails on a mismatch or a key left at init.
2. eval: the port's eval CLI (``cli.main --eval-only``) on the first test
   set, which writes ``<out>/inference/<dataset>/results.json`` and scores it
   when the ground truth is on disk.
3. diff: a row-level comparison of that ``results.json`` with one the
   reference produced on the same weights and set (``--ref-results``): the
   video sets and row counts equal, categories equal, scores within
   ``--score-rtol`` (1e-3), each mask's pixels agreeing on at least
   ``--pixel-agree`` (0.995) of the frame, as the JAX tool's bars.

``--dry-run`` proves the command path without zoo files: it saves the
port's model of the configuration, seeded random weights, as the ``.pth``,
writes the synthetic YouTube-VIS 2019 set (``tools/synth_data.py``) under
``DVIS_DATASETS``, shrinks the widths for the CPU, and runs the three
stages (the diff against its own output, which must pass).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch


def log(msg):
    print(f"[runbook] {msg}", flush=True)


def coverage_report(model: torch.nn.Module, path: str) -> dict:
    """Load ``path`` into ``model`` (``load_weights``) and report what it
    filled: {filled, total, mismatched, left_at_init, extra}."""
    from dvis_plus_tpu_torch.core.checkpoint import load_weights

    total = len(model.state_dict())
    skipped = load_weights(model, path)
    return {"filled": total - len(skipped["missing"]) - len(skipped["mismatched"]),
            "total": total, "mismatched": skipped["mismatched"],
            "left_at_init": skipped["missing"], "extra": skipped["unexpected"]}


def stage_convert(cfg, weights_path: str) -> dict:
    """Stage 1: load and report coverage; exits on a mismatch or a key left
    at init."""
    from dvis_plus_tpu_torch.cli import build_model

    rep = coverage_report(build_model(cfg.model), weights_path)
    log(f"convert: filled {rep['filled']}/{rep['total']} keys, {len(rep['mismatched'])} mismatched, "
        f"{len(rep['left_at_init'])} left at init, {len(rep['extra'])} extra")
    if rep["mismatched"]:
        raise SystemExit(f"[runbook] FAIL convert: shape mismatches {rep['mismatched'][:10]}")
    if rep["left_at_init"]:
        raise SystemExit(f"[runbook] FAIL convert: keys left at init {rep['left_at_init'][:20]}")
    return rep


def stage_eval(config_file: str, opts, output_dir: str, device: str) -> str:
    """Stage 2: the port's eval CLI. Returns the results.json path."""
    from dvis_plus_tpu_torch import cli

    res = cli.main(["--config-file", config_file, "--eval-only", "--device", device, *opts,
                    f"output_dir={output_dir}"])
    dataset = next(iter(res))
    path = os.path.join(output_dir, "inference", dataset, "results.json")
    if not os.path.exists(path):
        raise SystemExit(f"[runbook] FAIL eval: no {path}")
    log(f"eval: {dataset} -> {path} (scores: {res[dataset]})")
    return path


def stage_diff(our_path: str, ref_path: str, score_rtol: float = 1e-3,
               min_pixel_agree: float = 0.995) -> dict:
    """Stage 3: row-level diff of two YouTube-VIS results.json files, each
    video's rows sorted by (-score, category)."""
    from dvis_plus_tpu_torch.utils import rle as rle_codec

    def load(path):
        with open(path) as f:
            rows = json.load(f)
        by_video = {}
        for r in rows:
            by_video.setdefault(int(r["video_id"]), []).append(r)
        for v in by_video.values():
            v.sort(key=lambda r: (-r["score"], r["category_id"]))
        return by_video

    ours, ref = load(our_path), load(ref_path)
    if set(ours) != set(ref):
        raise SystemExit(f"[runbook] FAIL diff: video sets differ (ours-only "
                         f"{sorted(set(ours) - set(ref))[:5]}, ref-only {sorted(set(ref) - set(ours))[:5]})")

    def decode(seg, hw):
        if seg is None:
            return np.zeros(hw, bool)
        counts = seg["counts"]
        if isinstance(counts, str):
            counts = counts.encode("ascii")
        return rle_codec.decode({"size": seg["size"], "counts": counts}).astype(bool)

    n_rows, max_score_rel, min_agree, cat_mismatch = 0, 0.0, 1.0, 0
    for vid in sorted(ref):
        if len(ours[vid]) != len(ref[vid]):
            raise SystemExit(f"[runbook] FAIL diff: video {vid} row count "
                             f"{len(ours[vid])} vs {len(ref[vid])}")
        for o, r in zip(ours[vid], ref[vid]):
            n_rows += 1
            max_score_rel = max(max_score_rel, abs(o["score"] - r["score"]) / max(abs(r["score"]), 1e-5))
            cat_mismatch += int(o["category_id"] != r["category_id"])
            hw = next((tuple(s["size"]) for s in r["segmentations"] if s is not None), None)
            if hw is None:
                continue
            om = np.stack([decode(s, hw) for s in o["segmentations"]])
            rm = np.stack([decode(s, hw) for s in r["segmentations"]])
            min_agree = min(min_agree, float((om == rm).mean()))
    summary = {"videos": len(ref), "rows": n_rows, "max_score_rel": max_score_rel,
               "min_pixel_agree": min_agree, "category_mismatches": cat_mismatch,
               "ok": max_score_rel <= score_rtol and min_agree >= min_pixel_agree and cat_mismatch == 0}
    log(f"diff: {json.dumps(summary)}")
    if not summary["ok"]:
        raise SystemExit("[runbook] FAIL diff: outside parity thresholds")
    return summary


DRY_RUN_OPTS = [
    # CPU-sized widths; the command path is the real-weights run's
    "model.compute_dtype=float32",
    "model.pixel_decoder.conv_dim=32", "model.pixel_decoder.mask_dim=32",
    "model.pixel_decoder.transformer_enc_layers=1",
    "model.pixel_decoder.transformer_dim_feedforward=64",
    "model.transformer_decoder.hidden_dim=32",
    "model.transformer_decoder.num_queries=8",
    "model.transformer_decoder.nheads=4",
    "model.transformer_decoder.dim_feedforward=64",
    "model.transformer_decoder.dec_layers=2",
    "model.transformer_decoder.mask_dim=32",
    "model.transformer_decoder.reid_hidden_dim=64",
    "model.tracker.num_layers=2", "model.tracker.num_heads=4",
    "model.tracker.feedforward_dim=64",
    "input.min_size_test=64", "input.max_size_test=96",
    "input.min_size_train=[64]", "input.max_size_train=96",
    "input.sampling_frame_num=3",
    "test.window_size=3", "test.max_num=5",
]


def main(argv=None) -> dict:
    from dvis_plus_tpu_torch.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config-file", default="configs/dvis/dvis_online_r50_ytvis19.yaml")
    ap.add_argument("--weights", default="")
    ap.add_argument("--ref-results", default="", help="a reference-produced results.json to diff against")
    ap.add_argument("--dry-run", action="store_true",
                    help="seeded random weights and the synthetic set: prove the command path")
    ap.add_argument("--output-dir", default="")
    ap.add_argument("--score-rtol", type=float, default=1e-3)
    ap.add_argument("--pixel-agree", type=float, default=0.995)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default) raises without a card; cpu must be asked for")
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    opts = list(args.opts)
    workdir = args.output_dir or tempfile.mkdtemp(prefix="zoo_runbook_")
    if args.dry_run:
        from dvis_plus_tpu_torch.data.datasets.categories import YTVIS_2019_CLASSES
        from dvis_plus_tpu_torch.tools.synth_data import make_ytvis

        opts = DRY_RUN_OPTS + opts
        data_root = os.path.join(workdir, "datasets")
        make_ytvis(data_root, "ytvis_2019", YTVIS_2019_CLASSES, splits=("train", "valid"))
        os.environ["DVIS_DATASETS"] = data_root
        log(f"dry-run: synthetic ytvis_2019 at {data_root}")
    cfg = load_config(args.config_file, opts)
    weights = args.weights
    if args.dry_run:
        from dvis_plus_tpu_torch.cli import build_model

        torch.manual_seed(cfg.seed)
        weights = os.path.join(workdir, "synthetic_zoo.pth")
        torch.save(build_model(cfg.model).state_dict(), weights)
        log(f"dry-run: seeded random checkpoint at {weights}")
    elif not weights:
        raise SystemExit("[runbook] --weights is required (or --dry-run)")

    rep = stage_convert(cfg, weights)
    results = stage_eval(args.config_file, opts + [f"weights={weights}"],
                         os.path.join(workdir, "out"), args.device)
    ref = args.ref_results or (results if args.dry_run else "")
    summary = None
    if ref:
        summary = stage_diff(results, ref, args.score_rtol, args.pixel_agree)
    else:
        log("diff: skipped (--ref-results not given); run the reference's --eval-only on the same "
            "weights and pass its results.json")
    log("OK")
    return {"convert": rep, "results": results, "diff": summary}


if __name__ == "__main__":
    main()
