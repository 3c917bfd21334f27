"""The threaded eval pipeline and the download settings of the port's
``run_vis_inference``: with ``test.eval_pipeline`` on (post-processing on a
worker thread, the loader read ahead on another) and the ``runs`` download
at ``rle_col_k`` 8 and 1, the results.json rows are the same bytes as the
plain loop's with the packed download, for MinVIS, Video Mask2Former and
DVIS++ online; the worker runs in inference mode on its own thread; an
exception in the loader or in the worker reaches the caller."""
import threading

import numpy as np
import pytest
import torch

from dvis_plus_tpu_torch.cli import build_model
from dvis_plus_tpu_torch.engine.inference import run_vis_inference
from dvis_plus_tpu_torch.evaluation.evaluators import YTVISEvaluator
from tests.test_torch_common import images, tiny_cfg, tiny_minvis_cfg

torch.set_num_threads(2)

SETTINGS = {
    "packed_plain": dict(mask_download="packed", eval_pipeline=False),
    "runs_pipeline": dict(mask_download="runs", eval_pipeline=True),
    "runs_k1_pipeline": dict(mask_download="runs", eval_pipeline=True, rle_col_k=1),
    "runs_plain": dict(mask_download="runs", eval_pipeline=False),
}


def _cfg(arch, **test):
    cfg = tiny_cfg() if arch == "dvis_online" else tiny_minvis_cfg(arch)
    for k, v in test.items():
        setattr(cfg.test, k, v)
    return cfg


def _model(cfg):
    torch.manual_seed(0)
    return build_model(cfg.model).eval()


def _videos():
    for vid, (T, out) in enumerate([(5, (48, 72)), (3, (96, 144)), (4, (64, 96))], 1):
        yield {"images": images(T, seed=50 + vid), "image_size": np.asarray([56, 96]),
               "height": out[0], "width": out[1], "video_id": vid}


def _rows(arch, setting, tmp_path, loader=None):
    cfg = _cfg(arch, **SETTINGS[setting])
    ev = YTVISEvaluator("synthetic", str(tmp_path / setting))
    run_vis_inference(cfg, _model(cfg), loader or _videos(), ev)
    with open(ev.write_results(), "rb") as f:
        return f.read(), ev.predictions


@pytest.mark.parametrize("arch", ["minvis", "video_maskformer", "dvis_online"])
def test_pipeline_and_runs_write_the_plain_loops_bytes(arch, tmp_path):
    want, rows = _rows(arch, "packed_plain", tmp_path)
    assert len(rows) == 3 * 10 and any(s for r in rows for s in r["segmentations"])
    for setting in ("runs_pipeline", "runs_k1_pipeline", "runs_plain"):
        got, _ = _rows(arch, setting, tmp_path)
        assert got == want, setting


class _Probe(YTVISEvaluator):
    def __init__(self, *args, fail_on=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.fail_on, self.seen = fail_on, []

    def process(self, video_id, output):
        self.seen.append((threading.current_thread().name, torch.is_inference_mode_enabled(),
                          type(output["pred_masks"]).__name__))
        if video_id == self.fail_on:
            raise KeyError(f"evaluator failed on video {video_id}")
        super().process(video_id, output)


def test_worker_thread_runs_in_inference_mode(tmp_path):
    cfg = _cfg("minvis", **SETTINGS["runs_pipeline"])
    ev = _Probe("synthetic", str(tmp_path))
    main = threading.current_thread().name
    run_vis_inference(cfg, _model(cfg), _videos(), ev)
    assert [s[0] for s in ev.seen] == ["eval-post_0"] * 3 != [main] * 3
    assert all(s[1] for s in ev.seen) and {s[2] for s in ev.seen} == {"ColRunMasks"}
    assert [r["video_id"] for r in ev.predictions] == [1] * 10 + [2] * 10 + [3] * 10


def test_worker_exception_reaches_the_caller(tmp_path):
    cfg = _cfg("minvis", **SETTINGS["runs_pipeline"])
    ev = _Probe("synthetic", str(tmp_path), fail_on=2)
    with pytest.raises(KeyError, match="video 2"):
        run_vis_inference(cfg, _model(cfg), _videos(), ev)
    assert [r["video_id"] for r in ev.predictions] == [1] * 10


def test_loader_exception_reaches_the_caller(tmp_path):
    def broken():
        videos = _videos()
        yield next(videos)
        raise OSError("frame 3 of video 2 could not be read")

    cfg = _cfg("minvis", **SETTINGS["runs_pipeline"])
    ev = _Probe("synthetic", str(tmp_path))
    with pytest.raises(OSError, match="video 2"):
        run_vis_inference(cfg, _model(cfg), broken(), ev)
    assert [s[0] for s in ev.seen] == ["eval-post_0"]  # the first video was processed
