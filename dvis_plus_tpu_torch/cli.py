"""Training and evaluation CLI of the PyTorch port (the counterpart of
``train_net_video.py``):

    DVIS_DATASETS=<root> python -m dvis_plus_tpu_torch.cli \\
        --config-file configs/dvis/dvis_online_r50_ytvis19.yaml [--eval-only] [--resume] \\
        [--device cuda|cpu] [--trace-out <file.json>] [weights=<state_dict .pth/.npz>] \\
        [key.path=value ...]

Under torchrun (``torchrun --nproc_per_node N -m dvis_plus_tpu_torch.cli ...``)
each rank joins the process group (``parallel.mesh.init_distributed``: NCCL
and a card a rank, or gloo with ``--device cpu``): training is data-parallel,
its step equal to the one-process step over the whole batch
(``engine.trainer.build_train_step``), and eval stripes the videos over the
ranks, rank 0 writing the gathered rows (``evaluation.dist``). In one
process ``test.eval_devices`` fans the eval out over the cards
(``engine.parallel_eval``) and ``test.refiner_shard_devices`` shards the
offline refiner's objects over them (``parallel.sp``).

Without ``--eval-only`` it trains, as ``train_net_video.py::do_train``
(:112-190): the three stages of the DVIS++ recipe on the video instance,
panoptic (VIPSeg) and semantic (VSPW) sets of ``datasets.train``: MinVIS or
CTVIS (``minvis``, ``ctvis``: the bare
``Segmenter`` on any ported backbone, frames folded into the batch, trained
whole but for a ViT-Adapter's frozen trunk), DVIS++ online
(``dvis_online``: the tracker on the frozen segmenter) and DVIS++ offline
(``dvis_offline``: the refiner on the frozen online model, with its class
memory); DVIS-DAQ online (``daq_online``: the cutter on the frozen
segmenter, stage 2 then stage 3 from ``daq.increasing_step[0]``, each
batch cut to the frame-count curriculum's length first: ``engine.trainer.
daq_curriculum_slice``, its generator ``random.Random(seed + 17)`` as the
JAX CLI's :147-164) and offline (``daq_offline``: the refiner on the frozen
segmenter and cutter, over every sampled frame), also on the
class-agnostic object sets (``video_sot``); and the segmenter's pretraining on COCO pseudo-videos
(``image_instance`` sets, ``data/pseudo_video.py``): Mask2Former
(``maskformer``, clips of one frame) and Video Mask2Former
(``video_maskformer``, also on video sets) (``config.check_trainable``
refuses the rest, naming the ROADMAP item), ``solver.max_iter`` steps of
``engine.trainer``'s train step
from the port's loader (``data.build``), a line of ``metrics.jsonl`` and a
console line every 20 steps (``utils.events``), and a checkpoint
``<output_dir>/checkpoints/step_<n>.pth`` every ``solver.checkpoint_period``
steps and at the end (``core.checkpoint``). ``--resume`` takes up the newest
checkpoint there (weights, optimizer state, step, class memory; the loader skips the
clips already taken, the curriculum's generator the draws of the steps
taken, and the draws of a step follow from (seed, step)), so a resumed run
ends where an unbroken one does. ``weights=`` loads a state dict
before training, non-strictly: a key of another shape keeps the module's
initialization and is logged.

With ``--eval-only`` it evaluates
(``configs/dvis/dvis_offline_{swinl,vitl}_ytvis19.yaml``,
``configs/dvis/{minvis,ctvis}_*_ytvis19.yaml``,
``configs/dvis/video_maskformer_r50_ytvis19.yaml`` and ``configs/daq/*.yaml``
run the same way; ``model.meta_architecture`` picks ``DVISOnline``,
``DVISOffline``, the bare ``Segmenter`` (``minvis``, ``ctvis``),
``VideoMaskFormer``, ``ImageMaskFormer`` (``maskformer``), ``DAQOnline`` or
``DAQOffline``; the VIPSeg and VSPW YAMLs,
``configs/dvis/*_{vipseg,vspw}.yaml``, run the VPS and VSS tasks).

Loads the configuration (``config.load_config``) and the video datasets
(``data.catalog``, ``data.datasets.{ytvis,vps_vss}``, ``data.mapper``) with
the port's own host-side modules and routes each test set by task, as
``train_net_video.py::run_task_eval`` does: ``test.task=vos`` or ``mots``
(DVIS-DAQ only) runs ``engine.daq_inference.run_daq_inference``, MOTS
writing ``results.json`` through ``UniYTVISEvaluator``, VOS its PNGs;
``test.task=vps`` or a
``video_panoptic`` set runs ``run_vps_inference`` and writes
``<output_dir>/inference/<dataset>/{pred.json,pan_pred/}`` (VPQ and STQ
when the ground truth is on disk); ``vss`` or ``video_semantic`` runs
``run_vss_inference`` and writes one class PNG a frame (mIoU and VC); any
other set runs ``run_vis_inference`` and writes ``results.json`` (AP,
``evaluation.ytvos_eval``). ``--device cuda`` (the default) raises when no
card is present; only ``--device cpu`` runs on the CPU. Weights are a state
dict in the reference checkpoints' key space (the port's own
``state_dict()``, a zoo ``.pth``, a training checkpoint, or the same as
``.npz``); without ``weights=`` the model keeps its random initialization
from ``seed``. The CLI prints each set's result dict and returns them.
``--trace-out <file.json>`` (with ``--eval-only``) switches the program's
tracer on for the evaluation (``utils/trace.py``) and, once it ends, writes
its span totals, counters and records to the file.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

import torch

from dvis_plus_tpu_torch.core.checkpoint import load_weights
from dvis_plus_tpu_torch.utils import trace

logger = logging.getLogger("dvis_plus_tpu_torch.cli")


def build_model(model_cfg) -> torch.nn.Module:
    """The port's module for ``model_cfg.meta_architecture`` (the JAX
    package's ``train_net_video.py::build_model``), randomly initialized."""
    from dvis_plus_tpu_torch.models.meta.daq import DAQOffline, DAQOnline
    from dvis_plus_tpu_torch.models.meta.dvis_offline import DVISOffline
    from dvis_plus_tpu_torch.models.meta.dvis_online import DVISOnline
    from dvis_plus_tpu_torch.models.meta.video_maskformer import ImageMaskFormer, VideoMaskFormer
    from dvis_plus_tpu_torch.models.segmenter.segmenter import Segmenter

    archs = {"minvis": Segmenter, "ctvis": Segmenter, "maskformer": ImageMaskFormer,
             "video_maskformer": VideoMaskFormer, "dvis_online": DVISOnline,
             "dvis_offline": DVISOffline, "daq_online": DAQOnline, "daq_offline": DAQOffline}
    return archs[model_cfg.meta_architecture](model_cfg)


def _score(md, rows):
    from dvis_plus_tpu_torch.evaluation.ytvos_eval import evaluate_vis

    with open(md.json_file) as f:
        gt = json.load(f)
    nframes = {v["id"]: len(v["file_names"]) for v in gt["videos"]}
    gt_anns = [
        {"video_id": a["video_id"], "category_id": a["category_id"],
         "segmentations": a.get("segmentations"), "iscrowd": a.get("iscrowd", 0)}
        for a in gt.get("annotations", [])
    ]
    return evaluate_vis(gt_anns, rows, nframes)


# The task drivers below take ``make_loader(i, n)`` (the videos of worker i of
# n, ``data.build.build_test_loader``'s ``shard``) and run through
# ``engine.parallel_eval.run_device_parallel`` (``test.eval_devices`` cards,
# or ``devices``). ``fn_for(model) -> logits_masks_fn``: the open-vocabulary
# forward of a worker's copy of the model (``cli_ov``), or None.


def _fn(fn_for, model):
    return None if fn_for is None else fn_for(model)


def _eval_vis(cfg, model, md, make_loader, out_dir, fn_for=None, devices=None):
    """VIS (``run_vis_inference``), and VOS and MOTS (the DAQ eval loop with the
    MOTS evaluator, as ``train_net_video.py::run_task_eval``): VOS writes
    its PNGs and returns ``{"task": "vos"}``. The rows of every rank are
    gathered; rank 0 writes and scores them."""
    from dvis_plus_tpu_torch.engine.daq_inference import run_daq_inference
    from dvis_plus_tpu_torch.engine.inference import run_vis_inference
    from dvis_plus_tpu_torch.engine.parallel_eval import run_device_parallel
    from dvis_plus_tpu_torch.evaluation.dist import is_main_process
    from dvis_plus_tpu_torch.evaluation.evaluators import UniYTVISEvaluator, YTVISEvaluator

    task = cfg.test.task
    kind = UniYTVISEvaluator if task in ("vos", "mots") else YTVISEvaluator
    evaluator = kind(md.name, out_dir, contiguous_to_dataset_id={
        v: k for k, v in getattr(md, "thing_dataset_id_to_contiguous_id", {}).items()})
    if task in ("vos", "mots"):
        driver = lambda m, ld, ev: run_daq_inference(cfg, m, ld, ev)  # noqa: E731
    else:
        driver = lambda m, ld, ev: run_vis_inference(  # noqa: E731
            cfg, m, ld, ev, logits_masks_fn=_fn(fn_for, m))
    run_device_parallel(cfg, driver, make_loader, evaluator, model, devices)
    if task == "vos":
        return {"task": "vos"}
    path = evaluator.write_results()  # every rank's rows, gathered
    res = {"predictions": len(evaluator.predictions), "results_json": path}
    json_file = getattr(md, "json_file", None)
    if is_main_process() and json_file and os.path.exists(json_file):
        res.update(_score(md, evaluator.predictions))
    return res


def _eval_vps(cfg, model, md, make_loader, out_dir, fn_for=None, devices=None):
    """The thing-class count and the contiguous -> dataset id map come from
    the registered categories; without them, VIPSeg's 58 thing classes."""
    from dvis_plus_tpu_torch.data.datasets.vps_vss import panoptic_contiguous_maps
    from dvis_plus_tpu_torch.engine.inference import run_vps_inference
    from dvis_plus_tpu_torch.engine.parallel_eval import run_device_parallel
    from dvis_plus_tpu_torch.evaluation.evaluators import VPSEvaluator

    cats = getattr(md, "categories", None) or []
    if cats:
        _, contig_to_dataset, n_thing = panoptic_contiguous_maps(cats)
    else:
        contig_to_dataset, n_thing = {}, 58
    evaluator = VPSEvaluator(md.name, out_dir, contiguous_to_dataset_id=contig_to_dataset,
                             gt_json=getattr(md, "json_file", None), gt_dir=getattr(md, "gt_dir", None))
    run_device_parallel(cfg, lambda m, ld, ev: run_vps_inference(
        cfg, m, ld, ev, n_thing, logits_masks_fn=_fn(fn_for, m)), make_loader, evaluator, model, devices)
    return evaluator.evaluate()


def _eval_vss(cfg, model, md, make_loader, out_dir, fn_for=None, devices=None):
    from dvis_plus_tpu_torch.engine.inference import run_vss_inference
    from dvis_plus_tpu_torch.engine.parallel_eval import run_device_parallel
    from dvis_plus_tpu_torch.evaluation.evaluators import VSSEvaluator

    evaluator = VSSEvaluator(md.name, out_dir, gt_root=getattr(md, "gt_root", None),
                             split=getattr(md, "split", "val"),
                             num_classes=getattr(md, "num_classes", cfg.model.num_classes))
    run_device_parallel(cfg, lambda m, ld, ev: run_vss_inference(
        cfg, m, ld, ev, logits_masks_fn=_fn(fn_for, m)), make_loader, evaluator, model, devices)
    return evaluator.evaluate()


def eval_loaders(cfg, name: str, dataset_type: str):
    """``make_loader(i, n)`` of a test set: worker i's stripe of this
    rank's videos (``data.build.build_test_loader``)."""
    from dvis_plus_tpu_torch.data.build import build_test_loader

    return lambda i, n: build_test_loader(cfg, name, dataset_type=dataset_type,
                                          shard=None if n == 1 else (i, n))


LOG_EVERY = 20


def do_train(cfg, resume: bool, dev: torch.device, build=build_model, classifiers=(),
             log_every: int = LOG_EVERY):
    """Train ``cfg`` on ``dev``; returns the final ``TrainState``. ``build``
    makes the model of ``cfg.model`` (seeded by ``seed``); an
    open-vocabulary one trains against ``classifiers``, one a training set
    (``engine.trainer.build_train_step``). Under a process group
    (``parallel.mesh.init_distributed``) the step is data-parallel: each
    rank maps and trains its block of every batch (``parallel.mesh.
    batch_block``), the losses logged are the whole batch's, and rank 0
    alone writes ``metrics.jsonl`` and the checkpoints, which every rank
    resumes from."""
    from dvis_plus_tpu_torch.core import checkpoint as ckpt
    from dvis_plus_tpu_torch.data.build import build_combined_train_loader
    from dvis_plus_tpu_torch.engine.trainer import (
        build_train_step,
        curriculum_rng,
        daq_curriculum_slice,
        to_batch,
    )
    from dvis_plus_tpu_torch.losses.reid import ClassMemory
    from dvis_plus_tpu_torch.parallel.mesh import batch_block, world
    from dvis_plus_tpu_torch.utils.events import EventWriter, device_memory_stats

    rank, world_size = world()
    block = batch_block(cfg.solver.ims_per_batch, rank, world_size, cfg.parallel.model_parallel_size)
    grouped = torch.distributed.is_initialized()
    torch.manual_seed(cfg.seed)
    model = build(cfg.model)
    if cfg.weights:
        load_weights(model, cfg.weights)
    model = model.to(dev).train()
    train_step, init_state = build_train_step(cfg, model, classifiers)
    state = init_state()
    ckpt_dir = os.path.join(cfg.output_dir, "checkpoints")
    latest = ckpt.latest(ckpt_dir) if resume else None
    if latest:
        saved = ckpt.restore(latest)
        model.load_state_dict(saved["model"])
        state.optimizer.load_state_dict(saved["optimizer"])
        state.step = saved["step"]
        if saved.get("memory") is not None:
            state.memory = ClassMemory(**{k: v.to(dev) for k, v in saved["memory"].items()})
        torch.set_rng_state(saved["generator"])
        logger.info("resumed from %s (step %d)", latest, state.step)
    loader = build_combined_train_loader(cfg, seed=cfg.seed, start_batches=state.step,
                                         block=(block.start, block.size))
    curriculum = curriculum_rng(cfg, state.step)
    writer = EventWriter(cfg.output_dir) if rank == 0 else None
    for step in range(state.step, cfg.solver.max_iter):
        # a no-op but for DVIS-DAQ's online stage
        raw = daq_curriculum_slice(cfg, step, next(loader), curriculum)
        if grouped:
            raw["block"] = block
        state, metrics = train_step(state, to_batch(raw, dev))
        if writer is not None and step % log_every == 0:
            writer.write(step, {**{k: float(v) for k, v in metrics.items()},
                                **device_memory_stats(dev)})
            writer.log_console(step)
        if rank == 0 and ((step + 1) % cfg.solver.checkpoint_period == 0
                          or step + 1 == cfg.solver.max_iter):
            path = os.path.join(ckpt_dir, f"step_{step + 1:07d}.pth")
            ckpt.save(path, model, state.optimizer.state_dict(), state.step, torch.get_rng_state(),
                      state.memory)
            logger.info("saved %s", path)
    if writer is not None:
        writer.close()
    if grouped:
        torch.distributed.barrier()  # the last checkpoint is on disk for every rank
    return state


def main(argv=None) -> dict:
    from dvis_plus_tpu_torch.config import check_supported, check_trainable, is_ov, load_config
    from dvis_plus_tpu_torch.data.datasets.coco import register_all_coco
    from dvis_plus_tpu_torch.data.datasets.vps_vss import register_all_vipseg, register_all_vspw
    from dvis_plus_tpu_torch.data.datasets.ytvis import register_all_ytvis
    from dvis_plus_tpu_torch.parallel.mesh import init_distributed
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--eval-only", action="store_true",
                        help="evaluate the test sets; without it, train")
    parser.add_argument("--resume", action="store_true",
                        help="train on from the newest checkpoint of <output_dir>/checkpoints")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default) raises without a card; cpu must be asked for")
    parser.add_argument("--trace-out", metavar="FILE.json",
                        help="with --eval-only: trace the evaluation (utils/trace.py) and write the "
                             "span totals, counters and records here at its end")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if args.trace_out and not args.eval_only:
        parser.error("--trace-out traces an evaluation: give --eval-only")
    logging.basicConfig(level=logging.INFO)

    cfg = load_config(args.config_file, args.opts)
    # a setting the port cannot honour raises here
    if args.eval_only:
        check_supported(cfg)
    else:
        check_trainable(cfg)
    if is_ov(cfg):
        raise SystemExit("open-vocabulary configurations run through "
                         "python -m dvis_plus_tpu_torch.cli_ov")
    root = os.environ.get("DVIS_DATASETS", "datasets")
    for register in (register_all_ytvis, register_all_vipseg, register_all_vspw, register_all_coco):
        register(root)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    # under torchrun: this rank's card (NCCL) or the CPU (gloo)
    dev = init_distributed(args.device)
    if not args.eval_only:
        state = do_train(cfg, args.resume, dev)
        return {"step": state.step, "device": str(dev)}
    torch.manual_seed(cfg.seed)
    model = build_model(cfg.model)
    if cfg.weights:
        load_weights(model, cfg.weights)
    model = model.to(dev).eval()
    if args.trace_out:
        trace.reset()
        trace.enable()
    try:
        results = _evaluate(cfg, model, dev)
    finally:
        if args.trace_out:
            trace.disable()
            write_trace(args.trace_out)
    print(json.dumps(results, indent=2))
    return results


def write_trace(path: str) -> None:
    """The tracer's span totals, counters and records as one JSON file."""
    out = {"totals": trace.totals(), "counters": trace.counters(),
           "records": [r._asdict() for r in trace.records()]}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, default=str)
    logger.info("trace: %d records, %d counters -> %s", len(out["records"]), len(out["counters"]), path)


def _evaluate(cfg, model, dev) -> dict:
    """Every test set of ``cfg.datasets.test``, routed by its task."""
    from dvis_plus_tpu_torch.data.catalog import get_metadata

    results = {}
    types = list(cfg.datasets.dataset_type_test)
    for idx, name in enumerate(cfg.datasets.test):
        # the task follows test.task or the dataset's type, as in the JAX CLI
        dataset_type = types[idx] if idx < len(types) else "video_instance"
        out_dir = os.path.join(cfg.output_dir, "inference", name)
        if cfg.test.task in ("vos", "mots"):
            run = _eval_vis
        elif cfg.test.task == "vps" or dataset_type == "video_panoptic":
            run = _eval_vps
        elif cfg.test.task == "vss" or dataset_type == "video_semantic":
            run = _eval_vss
        else:
            run = _eval_vis
        res = run(cfg, model, get_metadata(name), eval_loaders(cfg, name, dataset_type), out_dir)
        results[name] = {**res, "device": str(dev)}
        logger.info("%s: %s", name, results[name])
    return results


if __name__ == "__main__":
    main()
