"""The AP cost of each serving deviation, on the port: overfit a tiny model
with the parity settings (fp32, exact deformable op, JV matchers) on a
synthetic YouTube-VIS set, then score the same weights under each serving
knob:

    python -m dvis_plus_tpu_torch.tools.serving_deviation_ap [--steps-scale 1.0] \\
        [--device cuda|cpu]

Counterpart: ``tools/serving_deviation_ap.py`` of the JAX package
(``measure`` :196, ``measure_swin`` :73, ``measure_vit`` :144), with the same
knobs and step counts, through the port's trainer (``cli.do_train``: its
loader, train step and checkpoints) and its eval loop (``cli._eval_vis``:
``run_vis_inference``, the ``results.json`` rows and their AP).

- ``measure``: the staged DVIS++ recipe (MinVIS 120 steps, the online
  tracker on it frozen 100, the offline refiner on both frozen 240), then
  each knob on the online and the offline model: ``bf16_compute``,
  ``bf16_msdeform_values``, ``auction_matcher``, ``pallas_local_msdeform``
  (the clamped deformable form; the JAX tool measures it on a TPU alone,
  where its Pallas kernel compiles: the port runs it anywhere, kernel B1 on
  the card) and ``serving_defaults`` (the first three at once);
- ``measure_swin``: a Swin MinVIS (150 steps), then ``bf16_compute``,
  ``swin_fast_softmax`` (bf16 scores) and ``swin_fused_attn`` (on a TPU
  alone in the JAX tool; in the port both values of the key run the same
  op, kernel B2 on the card, so its row equals the parity settings'). The
  trunk is a custom ``swin_tiny`` (embed 32, depths (1, 1, 2, 1), heads (1,
  2, 4, 8), window 4): the JAX tool names it ``swin_t`` beside such widths,
  and both packages build a named variant at its own widths (the full
  Swin-T); the heads are 32 wide, the one head width of kernel B2;
- ``measure_vit``: a ViT-Adapter MinVIS (150 steps, the trunk frozen), then
  ``bf16_compute``, ``vit_flash_attention`` (kernel B3 on the card),
  ``vit_extractor_coarse`` and ``vit_serving`` (both).

``steps_scale`` scales every stage's steps (at least ``min_steps``, 20 as
in the JAX tool). Prints a markdown table a model, then one JSON line.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile

import torch

SYNTH = "ytvis_2019_train"

# the tiny widths of the JAX tool's ``tests/test_overfit_families.py::tiny_cfg``
TINY = (
    "model.num_classes=2", "model.compute_dtype=float32",
    "model.pixel_decoder.conv_dim=32", "model.pixel_decoder.mask_dim=32",
    "model.pixel_decoder.transformer_enc_layers=1", "model.pixel_decoder.transformer_dim_feedforward=64",
    "model.transformer_decoder.hidden_dim=32", "model.transformer_decoder.num_queries=8",
    "model.transformer_decoder.nheads=4", "model.transformer_decoder.dim_feedforward=64",
    "model.transformer_decoder.dec_layers=2", "model.transformer_decoder.mask_dim=32",
    "model.transformer_decoder.reid_hidden_dim=32",
    "model.tracker.num_layers=2", "model.tracker.feedforward_dim=64", "model.tracker.num_heads=4",
    "model.tracker.matcher_solver=jv",
    "model.refiner.num_layers=2", "model.refiner.feedforward_dim=64", "model.refiner.num_heads=4",
    "model.criterion.train_num_points=256", "model.criterion.max_num_instances=4",
    "solver.ims_per_batch=2", "solver.base_lr=3e-4", "solver.warmup_iters=10", "solver.steps=[100000]",
    "input.sampling_frame_num=3", "input.min_size_train=[64]", "input.max_size_train=96",
    "input.min_size_test=64", "input.max_size_test=96",
    "test.window_size=3", "test.max_num=4",
    f"datasets.train=[{SYNTH}]", f"datasets.test=[{SYNTH}]",
)

BF16 = "model.compute_dtype=bfloat16"
VARIANTS = [
    ("parity", ()),
    ("bf16_compute", (BF16,)),
    ("bf16_msdeform_values", ("model.pixel_decoder.msdeform_value_dtype=bfloat16",)),
    ("auction_matcher", ("model.tracker.matcher_solver=auction",)),
    ("pallas_local_msdeform", ("model.pixel_decoder.msdeform_impl=pallas_local",)),
    ("serving_defaults", (BF16, "model.pixel_decoder.msdeform_value_dtype=bfloat16",
                          "model.tracker.matcher_solver=auction")),
]
SWIN_VARIANTS = [
    ("parity", ()),
    ("bf16_compute", (BF16,)),
    ("swin_fast_softmax", (BF16, "model.backbone.swin_fast_softmax=true")),
    ("swin_fused_attn", (BF16, "model.backbone.swin_fused_attn=true")),
]
VIT_VARIANTS = [
    ("parity", ()),
    ("bf16_compute", (BF16,)),
    ("vit_flash_attention", (BF16, "model.backbone.vit_flash_attention=true")),
    ("vit_extractor_coarse", (BF16, "model.backbone.vit_extractor_coarse=true")),
    ("vit_serving", (BF16, "model.backbone.vit_flash_attention=true",
                     "model.backbone.vit_extractor_coarse=true")),
]
SWIN = ("model.backbone.name=swin_tiny", "model.backbone.swin_embed_dim=32",
        "model.backbone.swin_depths=[1,1,2,1]", "model.backbone.swin_num_heads=[1,2,4,8]",
        "model.backbone.swin_window_size=4", "model.backbone.swin_drop_path_rate=0.0")
VIT = ("model.backbone.name=vit_adapter_dinov2", "model.backbone.vit_embed_dim=32",
       "model.backbone.vit_depth=2", "model.backbone.vit_num_heads=2",
       "model.backbone.vit_interaction_indexes=[[0,0],[1,1]]", "model.backbone.vit_conv_inplane=8",
       "model.backbone.vit_deform_num_heads=2")


def write_synth(root: str) -> None:
    """The synthetic YouTube-VIS set (two videos of 6 frames, two classes)
    under ``root``, registered (``ytvis_2019_train``)."""
    from dvis_plus_tpu_torch.data.datasets.ytvis import register_all_ytvis
    from dvis_plus_tpu_torch.tools.synth_data import make_ytvis

    make_ytvis(root, "ytvis_2019", ["person", "car"], splits=("train",))
    register_all_ytvis(root)


def _cfg(arch: str, out_dir: str, tag: str, *extra: str):
    from dvis_plus_tpu_torch.config import tiny

    return tiny(arch, *TINY, *extra, f"output_dir={os.path.join(out_dir, tag)}")


def train(cfg, steps: int, dev, weights: str = "") -> str:
    """``steps`` steps of the port's trainer from ``weights``; returns the
    final checkpoint's path."""
    from dvis_plus_tpu_torch.cli import do_train
    from dvis_plus_tpu_torch.config import check_trainable
    from dvis_plus_tpu_torch.core import checkpoint as ckpt

    cfg.solver.max_iter = cfg.solver.checkpoint_period = steps
    cfg.weights = weights
    check_trainable(cfg)
    do_train(cfg, False, dev, log_every=max(steps, 1))
    return ckpt.latest(os.path.join(cfg.output_dir, "checkpoints"))


def eval_ap(cfg, weights: str, dev, tag: str) -> float:
    """The AP of ``weights`` under ``cfg`` on the synthetic set, through the
    CLI's eval loop."""
    from dvis_plus_tpu_torch.cli import _eval_vis, build_model, eval_loaders
    from dvis_plus_tpu_torch.config import check_supported
    from dvis_plus_tpu_torch.core.checkpoint import load_weights
    from dvis_plus_tpu_torch.data.catalog import get_metadata

    check_supported(cfg)
    torch.manual_seed(cfg.seed)
    model = build_model(cfg.model)
    load_weights(model, weights)
    model = model.to(dev).eval()
    out = os.path.join(cfg.output_dir, "eval", tag)
    with torch.inference_mode():
        res = _eval_vis(cfg, model, get_metadata(SYNTH), eval_loaders(cfg, SYNTH, "video_instance"), out)
    return float(res["AP"])


def _score(cfg, weights, dev, variants, prefix):
    from dvis_plus_tpu_torch.config import apply_overrides

    return {name: round(eval_ap(apply_overrides(copy.deepcopy(cfg), knobs), weights, dev,
                                f"{prefix}_{name}"), 4)
            for name, knobs in variants}


def _steps(n: int, steps_scale: float, min_steps: int) -> int:
    return max(min_steps, int(n * steps_scale))


def measure(out_dir: str, dev, steps_scale: float = 1.0, min_steps: int = 20) -> dict:
    """Train the staged DVIS++ recipe once at the parity settings; score
    every knob. Returns {"online": {knob: AP}, "offline": {knob: AP}}."""
    s1 = train(_cfg("minvis", out_dir, "stage1"), _steps(120, steps_scale, min_steps), dev)
    cfg2 = _cfg("dvis_online", out_dir, "stage2")
    s2 = train(cfg2, _steps(100, steps_scale, min_steps), dev, s1)
    cfg3 = _cfg("dvis_offline", out_dir, "stage3", "solver.base_lr=1e-3")
    s3 = train(cfg3, _steps(240, steps_scale, min_steps), dev, s2)
    return {"online": _score(cfg2, s2, dev, VARIANTS, "online"),
            "offline": _score(cfg3, s3, dev, VARIANTS, "offline")}


def measure_swin(out_dir: str, dev, steps_scale: float = 1.0, min_steps: int = 20) -> dict:
    """A Swin MinVIS at the parity settings; every Swin knob. Returns
    {"swin": {knob: AP}}."""
    cfg = _cfg("minvis", out_dir, "swin", *SWIN)
    weights = train(cfg, _steps(150, steps_scale, min_steps), dev)
    return {"swin": _score(cfg, weights, dev, SWIN_VARIANTS, "swin")}


def measure_vit(out_dir: str, dev, steps_scale: float = 1.0, min_steps: int = 20) -> dict:
    """A ViT-Adapter MinVIS (the trunk frozen) at the parity settings; every
    ViT knob. Returns {"vit": {knob: AP}}."""
    cfg = _cfg("minvis", out_dir, "vit", *VIT, "model.backbone.vit_frozen=true")
    weights = train(cfg, _steps(150, steps_scale, min_steps), dev)
    return {"vit": _score(cfg, weights, dev, VIT_VARIANTS, "vit")}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps-scale", type=float, default=1.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default) raises without a card; cpu must be asked for")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    dev = torch.device(args.device)
    with tempfile.TemporaryDirectory(prefix="dvis_synth_") as tmp:
        write_synth(os.path.join(tmp, "data"))
        res = measure(tmp, dev, args.steps_scale)
        res.update(measure_swin(tmp, dev, args.steps_scale))
        res.update(measure_vit(tmp, dev, args.steps_scale))
    print("\n| knob (eval-time) | online AP | offline AP |\n|---|---|---|")
    for name in res["online"]:
        d_on = res["online"][name] - res["online"]["parity"]
        d_off = res["offline"][name] - res["offline"]["parity"]
        print(f"| {name} | {res['online'][name]:.3f} ({d_on:+.3f}) "
              f"| {res['offline'][name]:.3f} ({d_off:+.3f}) |")
    for key, title in (("swin", "Swin"), ("vit", "ViT-Adapter")):
        print(f"\n| {title} knob (eval-time) | segmenter AP |\n|---|---|")
        for name, ap in res[key].items():
            print(f"| {name} | {ap:.3f} ({ap - res[key]['parity']:+.3f}) |")
    print(json.dumps({**res, "device": str(dev)}))
    return res


if __name__ == "__main__":
    main()
