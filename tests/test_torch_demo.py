"""The port's demo (``python -m dvis_plus_tpu_torch.demo --device cpu``)
against ``demo_video.py`` on the three cases of ``tests/test_demo_cli.py``
(MinVIS with ``--vocabulary``, DVIS++ online with ``--chunk-size 3``, the
open-vocabulary custom classes with ``--random-text``), the same tiny YAML
and the same seeded ``.pth`` on both sides (the JAX demo converts it with
its zoo converter): one overlay a frame, and the decoded overlays equal on
at least 99.9 % of pixels. Both demos run as subprocesses with
``PYTHONHASHSEED=0`` (``--random-text`` seeds its classifier by ``hash``),
the three JAX runs in parallel. The open-vocabulary YAML names a CLIP trunk
(``model.backbone.name=clip_convnext_l``): the JAX package builds one from
the ``clip_*`` fields whatever the name says, the port asks for the name."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_demo_cli import N_FRAMES, OV_EXTRA, TINY_YAML

pytestmark = pytest.mark.slow  # three JAX demos: about a minute and a half

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "minvis": ("minvis", "", ["--vocabulary", "cat,dog"]),
    "online_chunked": ("dvis_online", "", ["--chunk-size", "3"]),
    "ov_custom_vocab": ("dvis_online",
                        OV_EXTRA.replace("  backbone:\n", "  backbone:\n    name: clip_convnext_l\n"),
                        ["--random-text", "--thing-classes", "cat,dog", "--stuff-classes", "sky"]),
}


def _frames(root):
    import cv2

    os.makedirs(root)
    rng = np.random.RandomState(0)
    for t in range(N_FRAMES):
        cv2.imwrite(os.path.join(root, f"{t:05d}.jpg"), rng.randint(0, 255, (64, 96, 3), np.uint8))
    return root


def _weights(cfg_path, ov, path):
    """The port model of the YAML, seeded, its mask and class heads scaled
    so that instances clear the 0.3 threshold, saved as a ``.pth``."""
    from dvis_plus_tpu_torch.cli import build_model
    from dvis_plus_tpu_torch.cli_ov import build_ov_model
    from dvis_plus_tpu_torch.config import load_config, ov_arch

    cfg = load_config(cfg_path)
    torch.manual_seed(3)
    if ov:
        cfg.model.ov.enabled = True
        cfg.model.meta_architecture = ov_arch(cfg)
        model = build_ov_model(cfg)
    else:
        model = build_model(cfg.model)
    sd = model.state_dict()
    for k in sd:
        if ".mask_embed." in k or ".class_embed." in k:
            sd[k] = sd[k] * 4.0
    torch.save(sd, path)


def _start(tmp, name):
    arch, extra, args = CASES[name]
    d = os.path.join(tmp, name)
    os.makedirs(d)
    cfg_path = os.path.join(d, "cfg.yaml")
    with open(cfg_path, "w") as f:
        f.write(TINY_YAML.format(arch=arch, extra=extra))
    pth = os.path.join(d, "w.pth")
    _weights(cfg_path, "--random-text" in args, pth)
    frames = _frames(os.path.join(d, "frames"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONHASHSEED="0", PYTHONPATH=REPO)
    common = ["--config-file", cfg_path, "--input", frames] + args
    jax_proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "demo_video.py"), *common, "--output",
         os.path.join(d, "jax"), f"weights={pth}"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port_proc = subprocess.Popen(
        [sys.executable, "-m", "dvis_plus_tpu_torch.demo", *common, "--device", "cpu", "--output",
         os.path.join(d, "port"), f"weights={pth}"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return d, jax_proc, port_proc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("demo"))
    started = {name: _start(tmp, name) for name in CASES}
    out = {}
    for name, (d, jax_proc, port_proc) in started.items():
        jax_log = jax_proc.communicate(timeout=900)[0]
        port_log = port_proc.communicate(timeout=900)[0]
        out[name] = (d, jax_proc.returncode, jax_log, port_proc.returncode, port_log)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_demo_matches_demo_video(runs, name):
    import cv2

    d, jax_rc, jax_log, port_rc, port_log = runs[name]
    assert jax_rc == 0, jax_log[-3000:]
    assert port_rc == 0, port_log[-3000:]
    files = sorted(f for f in os.listdir(os.path.join(d, "frames")))
    assert sorted(os.listdir(os.path.join(d, "port"))) == sorted(os.listdir(os.path.join(d, "jax"))) == files
    equal = total = drawn = 0
    for f in files:
        got = cv2.imread(os.path.join(d, "port", f))
        want = cv2.imread(os.path.join(d, "jax", f))
        frame = cv2.imread(os.path.join(d, "frames", f))
        assert got.shape == want.shape == frame.shape
        equal += int((got == want).all(-1).sum())
        total += got.shape[0] * got.shape[1]
        drawn += int((want != frame).any(-1).sum())
    assert equal >= 0.999 * total, (name, equal / total)
    assert drawn > 0.05 * total, (name, drawn / total)  # the overlays are not blank
    if name == "online_chunked":
        assert "chunked" in port_log
