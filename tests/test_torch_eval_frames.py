"""Where an eval frame is normalized: the eval mapper hands over a zeroed
uint8 canvas, and ``engine/inference.py::_frames`` normalizes it on the
model's device as it uploads a window. Its float32 canvas is the one the
mapper built on the host before (``(frame - mean) / std`` in numpy, zero
padding), bit for bit, in every window the video functions cut, the padded
tail window too; float32 inputs go up as they are. (``test_torch_cuda.py``
holds the same check on the card.)"""
import numpy as np
import pytest
import torch

from dvis_plus_tpu_torch.config import load_config
from dvis_plus_tpu_torch.data.mapper import YTVISDatasetMapper
from dvis_plus_tpu_torch.engine.inference import _frames, _pad_to
from dvis_plus_tpu_torch.utils import trace
from tests.test_torch_common import host_canvas

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _sample(T: int, seed: int = 0):
    """T frames of 64x96 through the eval mapper: a 48-pixel shorter edge
    gives 48x72, padded to 64x96 (divisibility 32)."""
    cfg = load_config(None, ["input.min_size_test=48", "input.max_size_test=80"])
    rng = np.random.RandomState(seed)
    frames = [rng.randint(0, 256, (64, 96, 3)).astype(np.uint8) for _ in range(T)]
    sample = YTVISDatasetMapper(cfg)({"_frames": frames, "length": T, "file_names": [""] * T})
    return cfg, sample


def test_eval_mapper_hands_over_a_zeroed_uint8_canvas():
    cfg, sample = _sample(3)
    images = sample["images"]
    assert images.dtype == np.uint8 and images.shape == (3, 64, 96, 3)
    assert list(sample["image_size"]) == [48, 72]
    assert not images[:, 48:].any() and not images[:, :, 72:].any()


@pytest.mark.parametrize("T,W_sz", [(7, 3), (6, 3), (5, 5)])
def test_uint8_windows_equal_the_float32_canvas(T, W_sz):
    """48x72 valid in a 64x96 canvas; 7 frames in windows of 3 pad the tail
    window with two repeats of the last frame (``_pad_to``). Each window of
    the uint8 canvas, normalized with its valid size, equals the same window
    of the host's float32 canvas: values (``torch.equal``), dtype, shape and
    strides (channels-last memory, an NCHW view)."""
    cfg, sample = _sample(T, seed=T)
    n = -(-T // W_sz) * W_sz
    u8, f32 = _pad_to(sample["images"], n), _pad_to(host_canvas(cfg, sample), n)
    for t0 in range(0, n, W_sz):
        got = _frames(u8[t0 : t0 + W_sz], CPU, cfg, sample["image_size"], min(W_sz, T - t0))
        want = _frames(f32[t0 : t0 + W_sz], CPU)
        assert got.dtype == want.dtype == torch.float32
        assert got.shape == want.shape == (W_sz, 3, 64, 96)
        assert got.stride() == want.stride()
        assert torch.equal(got, want), t0


def test_float32_windows_go_up_as_they_are_and_count_nothing():
    cfg, sample = _sample(4)
    f32 = host_canvas(cfg, sample)
    trace.enable()
    got = _frames(f32, CPU, cfg, sample["image_size"])
    assert torch.equal(got, torch.from_numpy(f32).permute(0, 3, 1, 2))
    assert trace.counters() == {}


def test_the_valid_size_defaults_to_the_whole_canvas():
    cfg = load_config(None)
    x = np.random.RandomState(5).randint(0, 256, (2, 32, 64, 3)).astype(np.uint8)
    got = _frames(x, CPU, cfg)
    want = host_canvas(cfg, {"images": x, "image_size": (32, 64)})
    assert torch.equal(got, torch.from_numpy(want).permute(0, 3, 1, 2))


def test_frames_on_card_counts_the_real_frames():
    """A padded window's repeats of the last frame are not counted."""
    cfg, sample = _sample(7)
    u8 = _pad_to(sample["images"], 9)
    trace.enable()
    for t0 in range(0, 9, 3):
        _frames(u8[t0 : t0 + 3], CPU, cfg, sample["image_size"], min(3, 7 - t0))
    _frames(sample["images"], CPU, cfg, sample["image_size"])  # a whole-video forward
    assert trace.counters() == {"eval.frames_on_card": 14}
