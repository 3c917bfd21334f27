"""Synthetic VSPW-layout video pools, written once per checkout from a fixed seed.

A pool is a directory ``VSPW_480p/data/<video>/origin/<frame>.jpg`` (and, for
training pools, ``mask/<frame>.png`` class maps, 1-based with 0 = void, as VSPW
stores them) with ``train.txt`` and ``val.txt`` listing every video. Its
content comes from the mix's ``pool`` parameters alone (``pool_seed`` among
them); a run's ``--seed`` only picks which videos, which frames and in what
order. A pool is written under a temporary name and renamed into place when
complete, so a run never reads half a pool.

Each video holds ``regions`` (a range) semantic regions: a region is the set of
pixels nearest to its centre under its own anisotropic metric, and centres and
metrics drift and breathe from frame to frame, so regions move and deform.
Every region has a class, a base colour and its own texture (smoothed noise),
which moves with it.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List

import numpy as np

_LOW = 4  # regions are laid out at 1/4 resolution and upsampled


def pool_dir(root: str, params: Dict[str, Any]) -> str:
    key = hashlib.sha256(json.dumps(params, sort_keys=True).encode()).hexdigest()[:12]
    return os.path.join(root, f"pool-{key}")


def video_names(params: Dict[str, Any]) -> List[str]:
    return [f"v{i:03d}" for i in range(int(params["videos"]))]


def _video(out: str, name: str, index: int, p: Dict[str, Any]) -> None:
    import cv2

    rng = np.random.default_rng([int(p["pool_seed"]), index])
    H, W, T = int(p["height"]), int(p["width"]), int(p["frames"])
    h, w = -(-H // _LOW), -(-W // _LOW)
    lo, hi = p["regions"]
    R = int(rng.integers(lo, hi + 1))
    centre = rng.uniform([0, 0], [h, w], size=(R, 2))
    vel = rng.normal(0, 0.6, size=(R, 2))
    aniso = rng.uniform(0.5, 2.0, size=(R, 2))
    phase = rng.uniform(0, 2 * np.pi, size=R)
    classes = rng.integers(1, int(p.get("num_classes", 124)) + 1, size=R)
    base = rng.uniform(30, 225, size=(R, 3))
    m = 64  # texture margin the motion slides over
    tex = []
    for _ in range(R):
        noise = rng.normal(0, 1, size=(H // 4 + 2 * m, W // 4 + 2 * m, 3)).astype(np.float32)
        noise = cv2.GaussianBlur(noise, (0, 0), float(rng.uniform(1.0, 3.0)))
        noise = cv2.resize(noise, (W + 8 * m, H + 8 * m), interpolation=cv2.INTER_LINEAR)
        tex.append(noise * (40.0 / (noise.std() + 1e-6)))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img_dir = os.path.join(out, name, "origin")
    os.makedirs(img_dir)
    if p.get("masks"):
        os.makedirs(os.path.join(out, name, "mask"))
    q = [int(cv2.IMWRITE_JPEG_QUALITY), int(p.get("jpeg_quality", 90))]
    for t in range(T):
        c = centre + vel * t
        c = np.abs((c + [h, w]) % (2 * np.array([h, w])) - [h, w])  # bounce off the borders
        s = aniso * (1.0 + 0.25 * np.sin(0.15 * t + phase))[:, None]
        d = ((yy[None] - c[:, 0, None, None]) / s[:, 0, None, None]) ** 2 + \
            ((xx[None] - c[:, 1, None, None]) / s[:, 1, None, None]) ** 2
        low = np.argmin(d, axis=0).astype(np.uint8)
        lab = cv2.resize(low, (W, H), interpolation=cv2.INTER_NEAREST)
        frame = np.empty((H, W, 3), np.float32)
        for r in range(R):
            oy = int(np.clip(4 * m + 4 * vel[r, 0] * t, 0, 8 * m)) % (8 * m)
            ox = int(np.clip(4 * m + 4 * vel[r, 1] * t, 0, 8 * m)) % (8 * m)
            sel = lab == r
            frame[sel] = base[r] + tex[r][oy : oy + H, ox : ox + W][sel]
        bgr = np.clip(frame, 0, 255).astype(np.uint8)[:, :, ::-1]
        ok, buf = cv2.imencode(".jpg", bgr, q)
        if not ok:
            raise RuntimeError("JPEG encoding failed")
        buf.tofile(os.path.join(img_dir, f"{t:05d}.jpg"))
        if p.get("masks"):
            cv2.imwrite(os.path.join(out, name, "mask", f"{t:05d}.png"), classes[lab].astype(np.uint8))


def ensure_pool(root: str, params: Dict[str, Any], workers: int = 4) -> str:
    """The pool of ``params`` under ``root``, written first if absent. Returns
    the dataset root (holding ``VSPW_480p``)."""
    final = pool_dir(root, params)
    if os.path.exists(os.path.join(final, "DONE")):
        return final
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    data = os.path.join(tmp, "VSPW_480p", "data")
    os.makedirs(data)
    names = video_names(params)
    with ThreadPoolExecutor(workers) as ex:
        list(ex.map(lambda a: _video(data, a[1], a[0], params), enumerate(names)))
    for split in ("train", "val"):
        with open(os.path.join(tmp, "VSPW_480p", f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    with open(os.path.join(tmp, "params.json"), "w") as f:
        json.dump(params, f, sort_keys=True)
    open(os.path.join(tmp, "DONE"), "w").close()
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    return final
