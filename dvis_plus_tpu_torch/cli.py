"""VIS evaluation CLI of the PyTorch port (the counterpart of
``train_net_video.py --eval-only`` for the ported slice):

    DVIS_DATASETS=<root> python -m dvis_plus_tpu_torch.cli \\
        --config-file configs/dvis/dvis_online_r50_ytvis19.yaml --eval-only \\
        [weights=<state_dict .pth/.npz>] [key.path=value ...]

(``configs/dvis/dvis_offline_swinl_ytvis19.yaml`` runs the offline Swin-L
model the same way; ``model.meta_architecture`` picks ``DVISOnline`` or
``DVISOffline``.)

Loads the configuration and the video datasets with the JAX package's
host-side modules (config YAML, dataset catalog and eval mapper; no jax),
runs the port's ``run_vis_inference`` on CUDA when a card is present and on
the CPU otherwise, and writes ``<output_dir>/inference/<dataset>/results.json``.
Weights are a state dict in the reference checkpoints' key space (the port's
own ``state_dict()``, a zoo ``.pth``, or the same as ``.npz``); without
``weights=`` the model keeps its random initialization from ``seed``. AP is
scored with the JAX package's YouTube-VIS scorer when the dataset has
ground truth.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

logger = logging.getLogger("dvis_plus_tpu_torch.cli")


def load_weights(model: torch.nn.Module, path: str) -> None:
    """Load a reference-keyed state dict (``.npz`` or a torch checkpoint,
    optionally wrapped in ``{"model": ...}``) into ``model``, non-strict like
    the reference's checkpointer; missing and unexpected keys are logged."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            sd = {k: torch.from_numpy(data[k]) for k in data.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for key in ("model", "state_dict"):
            if isinstance(sd, dict) and isinstance(sd.get(key), dict):
                sd = sd[key]
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if missing or unexpected:
        logger.warning("load_weights(%s): %d missing, %d unexpected keys",
                       path, len(missing), len(unexpected))


def _score(md, rows):
    from dvis_plus_tpu.evaluation.ytvos_eval import evaluate_vis

    with open(md.json_file) as f:
        gt = json.load(f)
    nframes = {v["id"]: len(v["file_names"]) for v in gt["videos"]}
    gt_anns = [
        {"video_id": a["video_id"], "category_id": a["category_id"],
         "segmentations": a.get("segmentations"), "iscrowd": a.get("iscrowd", 0)}
        for a in gt.get("annotations", [])
    ]
    return evaluate_vis(gt_anns, rows, nframes)


def main(argv=None) -> dict:
    from dvis_plus_tpu.core.config import load_config
    from dvis_plus_tpu.data.build import mapper_for_type
    from dvis_plus_tpu.data.catalog import get_dataset, get_metadata
    from dvis_plus_tpu.data.datasets.ytvis import register_all_ytvis

    from dvis_plus_tpu_torch.engine.inference import run_vis_inference
    from dvis_plus_tpu_torch.evaluation.evaluators import YTVISEvaluator
    from dvis_plus_tpu_torch.models.meta.dvis_offline import DVISOffline
    from dvis_plus_tpu_torch.models.meta.dvis_online import DVISOnline

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--eval-only", action="store_true", required=True,
                        help="training is not ported; evaluation only")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = load_config(args.config_file, args.opts)
    register_all_ytvis(os.environ.get("DVIS_DATASETS", "datasets"))
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    torch.manual_seed(cfg.seed)
    arch = {"dvis_online": DVISOnline, "dvis_offline": DVISOffline}.get(cfg.model.meta_architecture)
    if arch is None:
        raise NotImplementedError(f"meta_architecture {cfg.model.meta_architecture!r} is not ported yet")
    model = arch(cfg.model)
    if cfg.weights:
        load_weights(model, cfg.weights)
    model = model.to(dev).eval()

    results = {}
    for name in cfg.datasets.test:
        md = get_metadata(name)
        mapper = mapper_for_type(cfg, "video_instance", False, dataset_name=name)
        loader = (mapper(rec, seed=0) for rec in get_dataset(name))
        evaluator = YTVISEvaluator(
            name, os.path.join(cfg.output_dir, "inference", name),
            contiguous_to_dataset_id={
                v: k for k, v in getattr(md, "thing_dataset_id_to_contiguous_id", {}).items()
            },
        )
        run_vis_inference(cfg, model, loader, evaluator)
        res = {"predictions": len(evaluator.predictions),
               "results_json": evaluator.write_results(), "device": str(dev)}
        json_file = getattr(md, "json_file", None)
        if json_file and os.path.exists(json_file):
            res.update(_score(md, evaluator.predictions))
        results[name] = res
        logger.info("%s: %s", name, res)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
