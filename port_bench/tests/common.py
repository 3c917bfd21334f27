"""Small settings the CPU tests share: the cell's configuration at tiny widths
and a tiny video pool, run through the benchmark's driver on the CPU."""
from __future__ import annotations

import copy
import math
import time
from types import SimpleNamespace

from port_bench.bench import registry

CELL = "vitl_offline_vspw.stream"

TINY = (
    "model.compute_dtype=float32",
    "model.backbone.vit_embed_dim=32", "model.backbone.vit_depth=4", "model.backbone.vit_num_heads=2",
    "model.backbone.vit_deform_num_heads=2", "model.backbone.vit_conv_inplane=8",
    "model.backbone.vit_interaction_indexes=[[0,0],[1,1],[2,2],[3,3]]",
    "model.pixel_decoder.conv_dim=32", "model.pixel_decoder.mask_dim=32",
    "model.pixel_decoder.transformer_enc_layers=1", "model.pixel_decoder.transformer_dim_feedforward=64",
    "model.transformer_decoder.hidden_dim=32", "model.transformer_decoder.num_queries=8",
    "model.transformer_decoder.nheads=4", "model.transformer_decoder.dim_feedforward=64",
    "model.transformer_decoder.dec_layers=2", "model.transformer_decoder.mask_dim=32",
    "model.transformer_decoder.reid_hidden_dim=32",
    "model.tracker.num_layers=2", "model.tracker.feedforward_dim=64",
    "model.refiner.num_layers=2", "model.refiner.feedforward_dim=64",
    "input.min_size_test=64", "input.max_size_test=96",
)


def tiny_mix(**pool):
    _, _, mix = registry.workload(CELL)
    mix = copy.deepcopy(mix)
    mix["pool"].update({"videos": 3, "frames": 12, "height": 64, "width": 96, **pool})
    mix["lengths"] = {"pairs": [[4, 9], [5, 8]]}
    mix["plan_videos"] = 4
    mix["warmup_frames"] = 3
    mix["check"] = {"mask_pixels": 64}
    return mix


def ctx(tmp_path, seed=7, trace=False, overrides=(), tamper=None, limits=None,
        seconds=math.inf, mix=None, plan=None):
    cell, cfg_entry, _ = registry.workload(CELL)
    cfg_file = registry.config_file(cfg_entry)
    return SimpleNamespace(
        cell=cell, cfg_file=cfg_file, adapter=registry.adapter(cfg_file), mix=mix or tiny_mix(),
        seed=seed, seconds=seconds, trace=trace, device="cpu", t_start=time.perf_counter(),
        overrides=TINY + tuple(overrides), pools=str(tmp_path / "pools"), cache=str(tmp_path / "cache"),
        limits=limits if limits is not None else {"tracker_embeds": 1e-4, "refiner_logits": 1e-4,
                                                  "mask_samples": 1e-4, "map_frame_mismatch": 0.0},
        plan=plan, tamper=tamper, with_control=False)
