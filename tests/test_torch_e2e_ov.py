"""Open vocabulary end to end: ``python -m dvis_plus_tpu_torch.cli_ov
--eval-only --device cpu`` against ``train_net_video_ov.py --eval-only``,
both in subprocesses, with the same seeded weights (the port's state dict as
``.npz``, which the JAX CLI converts with ``core/zoo_convert.py``) and the
same text classifiers, on ``tools/synth_data.py``'s sets:

- YouTube-VIS 2019 (2 videos of 8 frames, windows of 4): DVIS++ online OV
  and offline OV with ``--clip-weights`` (a seeded 2-layer open_clip text
  tower of width 64, as ``.npz``) and ``--bpe`` (a small merges file
  written here), MinVIS OV with ``--random-text``: the same
  ``results.json`` row for row (``assert_rows_equal``);
- VIPSeg (VPS, DVIS++ online OV) and VSPW (VSS, DVIS++ offline OV, windows
  of 3 over 6 frames) with ``--random-text``: the same ``pred.json`` and
  panoptic PNGs, and VPQ / STQ; the same class PNGs and mIoU / VC.

``--random-text`` seeds each prompt's vectors with Python's ``hash`` of the
prompts, which is randomized per process: every CLI here runs under
``PYTHONHASHSEED=0``, so both packages draw the same classifier. The tiny
models: ConvNeXt depths (1, 1, 2, 1) at widths (16, 24, 32, 40), CLIP
embedding 24, Q = 8; every ``logit_scale`` is 4 (scores spread over the
classes) but the refiner's, 1 (at 4 its random void row takes nearly all
of the probability, and the scores left are of the order of the +1e-8 in
``log(p + 1e-8)``), and the mask heads are x5 a layer (mask logits of a
trained model's order). All ten CLI processes start together."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.test_torch_common import E2E_TINY, _scaled, open_clip_text_state_dict, random_params
from tests.test_torch_ov_text import write_merges

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OV_TINY = [o for o in E2E_TINY if "reid_hidden_dim" not in o] + [
    "model.backbone.clip_depths=[1,1,2,1]", "model.backbone.clip_dims=[16,24,32,40]",
    "model.ov.clip_embed_dim=24", "model.transformer_decoder.num_queries=8",
    "model.tracker.num_layers=1", "model.tracker.feedforward_dim=64", "model.tracker.num_heads=4",
    "model.refiner.num_layers=1", "model.refiner.feedforward_dim=64", "model.refiner.num_heads=4",
]  # the default auction matcher: see tests/test_torch_common.py::tiny_ov_cfg
RUNS = {  # tag: (yaml, dataset, text mode, extra overrides)
    "online": ("ov_online_convnextl_zeroshot_ytvis19", "ytvis_2019_val", "clip", []),
    "offline": ("ov_offline_convnextl_zeroshot_ytvis19", "ytvis_2019_val", "clip", []),
    "minvis": ("ov_minvis_convnextl_zeroshot_ytvis19", "ytvis_2019_val", "random", []),
    "vps": ("ov_online_convnextl_zeroshot_vipseg", "panoVSPW_vps_video_val", "random", []),
    "vss": ("ov_offline_convnextl_zeroshot_vspw", "VSPW_vss_video_val", "random", ["test.window_size=3"]),
}


def ov_weights(yaml: str, opts, path: str) -> None:
    """Seeded weights for the OV model of ``yaml`` + ``opts``, saved as the
    port's state dict (``.npz``)."""
    from dvis_plus_tpu.core.config import load_config
    from dvis_plus_tpu_torch.convert import state_dict_from_jax
    from train_net_video_ov import _ov_arch, build_ov_model

    cfg = load_config(yaml, list(opts))
    cfg.model.ov.enabled = True
    cfg.model.meta_architecture = _ov_arch(cfg)
    model = build_ov_model(cfg)
    x = jnp.zeros((2, 64, 96, 3)) if cfg.model.meta_architecture == "minvis_ov" else jnp.zeros((1, 2, 64, 96, 3))
    tc = jnp.zeros((2, cfg.model.ov.clip_embed_dim))
    shapes = jax.eval_shape(lambda r, x, t: model.init(r, x, t, (1, 1, 1)), jax.random.key(0), x, tc)
    params = {"params": _scaled(random_params(shapes["params"], seed=11), {"mask_embed": 5.0})}

    def scales(tree, value=4.0):
        return {k: scales(v, 1.0 if k == "refiner" else value) if isinstance(v, dict) else
                (np.float32(value) if k == "logit_scale" else v) for k, v in tree.items()}

    sd = state_dict_from_jax(scales(params))
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("e2e_ov"))
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from synth_data import make_vipseg, make_vspw, make_ytvis

    from dvis_plus_tpu.data.datasets.categories import YTVIS_2019_CLASSES

    data = os.path.join(tmp, "data")
    make_ytvis(data, "ytvis_2019", YTVIS_2019_CLASSES, splits=("valid",), n_videos=2, length=8)
    make_vipseg(data, n_videos=2, length=6)
    make_vspw(data, n_videos=2, length=6)
    text = os.path.join(tmp, "text.npz")
    # CLIP's vocabulary and context: the JAX CLI builds its text tower at those sizes
    np.savez(text, **open_clip_text_state_dict(prefix="text.", vocab=49408, context=77))
    bpe = write_merges(os.path.join(tmp, "merges.txt.gz"))
    env = dict(os.environ, DVIS_DATASETS=data, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, PYTHONHASHSEED="0",
               CUDA_VISIBLE_DEVICES="")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for tag, (name, dataset, mode, extra) in RUNS.items():
        yaml = f"configs/ov/{name}.yaml"
        opts = OV_TINY + extra + [f"datasets.test=[{dataset}]"]
        weights = os.path.join(tmp, f"{tag}.npz")
        ov_weights(yaml, opts, weights)
        text_args = ["--random-text"] if mode == "random" else ["--clip-weights", text, "--bpe", bpe]
        # the port's processes take 2 threads each: ten processes share the machine
        side_env = {"jax": env, "port": dict(env, OMP_NUM_THREADS="2")}
        for side, cmd in (("jax", [sys.executable, "train_net_video_ov.py"]),
                          ("port", [sys.executable, "-m", "dvis_plus_tpu_torch.cli_ov", "--device", "cpu"])):
            out = os.path.join(tmp, f"{side}_{tag}")
            procs[tag, side] = (out, dataset, subprocess.Popen(
                [*cmd, "--config-file", yaml, "--eval-only", *text_args, *opts, f"weights={weights}",
                 f"output_dir={out}"],
                cwd=REPO, env=side_env[side], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = {}
    try:
        for key, (out, dataset, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=900)
            assert proc.returncode == 0, f"{key}: {stderr[-3000:]}"
            printed = json.loads(stdout[stdout.index("{\n"):])[dataset]  # the results dict printed last
            results[key] = (printed, os.path.join(out, "inference", dataset))
    finally:
        for _, _, proc in procs.values():
            proc.kill()  # no-op once it has ended
    return results


def _rows(runs, tag):
    out = []
    for side in ("port", "jax"):
        with open(os.path.join(runs[tag, side][1], "results.json")) as f:
            out.append(json.load(f))
    return out


@pytest.mark.parametrize("tag", ["online", "offline", "minvis"])
def test_vis_results_json_equal(runs, tag):
    from tests.test_torch_common import assert_rows_equal

    got, want = _rows(runs, tag)
    assert_rows_equal(got, want)
    assert {r["video_id"] for r in got} == {1, 2} and len(got) == 2 * 5
    assert len({r["score"] for r in got}) == len(got) and min(r["score"] for r in got) > 1e-3
    assert runs[tag, "port"][0]["device"] == "cpu"


def _png(path):
    import cv2

    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


def test_vps_outputs_equal(runs):
    (got, port_dir), (want, jax_dir) = runs["vps", "port"], runs["vps", "jax"]
    with open(os.path.join(port_dir, "pred.json")) as f, open(os.path.join(jax_dir, "pred.json")) as g:
        assert json.load(f) == json.load(g)
    names = sorted(os.path.relpath(os.path.join(d, f), jax_dir)
                   for d, _, fs in os.walk(jax_dir) for f in fs if f.endswith(".png"))
    assert len(names) == 2 * 6
    for name in names:
        np.testing.assert_array_equal(_png(os.path.join(port_dir, name)),
                                      _png(os.path.join(jax_dir, name)), err_msg=name)
    assert json.dumps({k: got[k] for k in want}, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_vss_outputs_equal(runs):
    (got, port_dir), (want, jax_dir) = runs["vss", "port"], runs["vss", "jax"]
    names = sorted(os.path.relpath(os.path.join(d, f), jax_dir)
                   for d, _, fs in os.walk(jax_dir) for f in fs if f.endswith(".png"))
    assert len(names) == 2 * 6
    for name in names:
        np.testing.assert_array_equal(_png(os.path.join(port_dir, name)),
                                      _png(os.path.join(jax_dir, name)), err_msg=name)
    assert json.dumps({k: got[k] for k in want}, sort_keys=True) == json.dumps(want, sort_keys=True)
