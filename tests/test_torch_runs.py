"""The ``runs`` mask download: the port's ``_upsample_runs`` payloads equal
the JAX package's element for element, and ``paged_inference_video`` gives
the same RLE strings with ``runs`` as with ``packed`` at ``k_col`` 8 (every
frame from its change rows) and 1 (most frames fall back to their packed
pixels, some not), from masks on the device and paged to the host, and at an output
one row high (no changes within a column: the packed download). Mirrors
``tests/test_long_video_paging.py::test_paged_inference_video_runs_equals_packed``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.engine.inference import _upsample_runs as jax_upsample_runs
from dvis_plus_tpu.engine.inference import paged_inference_video as jax_paged
from dvis_plus_tpu_torch.engine.inference import _upsample_runs, paged_inference_video
from dvis_plus_tpu_torch.utils.rle import ColRunMasks, PackedMasks

torch.set_num_threads(2)

# (img_size, output_size, padded_size): second stage down, mixed, up, 2 rows
SIZES = {
    "down": ((60, 60), (37, 53), (64, 64)),
    "mixed": ((48, 64), (30, 100), (64, 64)),
    "up": ((60, 56), (90, 112), (64, 64)),
    "two_rows": ((16, 16), (2, 9), (16, 16)),
}


def _smooth_masks(seed, Q, T):
    """Mask logits smooth at the 16x16 scale: blobs with at most 3 changes a
    column at the test's output, so ``k_col=8`` holds every frame and
    ``k_col=1`` a few."""
    rng = np.random.RandomState(seed)
    coarse = torch.from_numpy(rng.randn(Q, T, 4, 4).astype(np.float32))
    return torch.nn.functional.interpolate(coarse, size=(16, 16), mode="bilinear").numpy() + 0.3


@pytest.mark.parametrize("k_col", [8, 3, 1])
@pytest.mark.parametrize("case", sorted(SIZES))
def test_upsample_runs_payload_matches_jax(case, k_col):
    masks = np.random.RandomState(3).randn(5, 4, 16, 16).astype(np.float32)
    masks[1] = _smooth_masks(4, 1, 4)[0]
    want = np.asarray(jax_upsample_runs(jnp.asarray(masks), *SIZES[case], k_col=k_col))
    got = _upsample_runs(torch.from_numpy(masks), *SIZES[case], k_col)
    assert got.dtype == torch.int16 and want.dtype == np.uint16
    np.testing.assert_array_equal(got.numpy().view(np.uint16), want)


def _strings(masks):
    return {(i, t): masks.encode_frame(i, t)["counts"]
            for i in range(masks.shape[0]) for t in range(masks.shape[1]) if masks.frame_any(i, t)}


@pytest.mark.parametrize("source", ["device", "host_fp16"])
@pytest.mark.parametrize("k_col", [8, 1])
def test_paged_runs_equals_packed(k_col, source):
    rng = np.random.RandomState(5)
    Q, K1, T = 12, 6, 11
    logits = torch.from_numpy(rng.randn(Q, K1).astype(np.float32))
    masks = torch.from_numpy(_smooth_masks(6, Q, T))
    if source == "host_fp16":
        masks = masks.half()
    kw = dict(img_size=(60, 60), output_size=(37, 53), padded_size=(64, 64), topk=7, chunk=4)
    s_pk, l_pk, pk = paged_inference_video(logits, masks, download="packed", **kw)
    s_cr, l_cr, cr = paged_inference_video(logits, masks, download="runs", k_col=k_col, **kw)
    assert isinstance(pk, PackedMasks) and isinstance(cr, ColRunMasks)
    assert torch.equal(s_pk, s_cr) and torch.equal(l_pk, l_cr)
    frames = 7 * T
    assert not cr.fallback if k_col == 8 else frames // 2 < len(cr.fallback) < frames
    assert [[cr.frame_any(i, t) for t in range(T)] for i in range(7)] == \
           [[pk.frame_any(i, t) for t in range(T)] for i in range(7)]
    assert _strings(cr) == _strings(pk) and len(_strings(pk)) > frames // 2
    np.testing.assert_array_equal(cr.unpack(), pk.unpack())
    # the same containers as the JAX package's, array for array
    _, _, want = jax_paged(jnp.asarray(logits.float().numpy()), jnp.asarray(masks.float().numpy()),
                           download="runs", k_col=k_col, **kw)
    for name in ("rows", "m_col", "jumps", "first"):
        np.testing.assert_array_equal(getattr(cr, name), getattr(want, name), err_msg=name)
    assert sorted(cr.fallback) == sorted(want.fallback)


def test_paged_runs_one_row_high_takes_packed():
    """``oh = 1``: no change within a column to extract, so ``runs`` takes
    the packed download, as the JAX function does."""
    rng = np.random.RandomState(7)
    logits = torch.from_numpy(rng.randn(6, 4).astype(np.float32))
    masks = torch.from_numpy(rng.randn(6, 3, 16, 16).astype(np.float32))
    kw = dict(img_size=(16, 16), output_size=(1, 13), padded_size=(16, 16), topk=5, chunk=2)
    _, _, runs = paged_inference_video(logits, masks, download="runs", **kw)
    _, _, packed = paged_inference_video(logits, masks, download="packed", **kw)
    _, _, want = jax_paged(jnp.asarray(logits.numpy()), jnp.asarray(masks.numpy()), download="runs", **kw)
    assert isinstance(runs, PackedMasks)
    np.testing.assert_array_equal(runs.bits, packed.bits)
    np.testing.assert_array_equal(runs.bits, want.bits)
    assert _strings(runs) == _strings(packed) and _strings(runs)


def test_unknown_mask_download_raises():
    with pytest.raises(ValueError, match="raw"):
        paged_inference_video(torch.zeros(4, 3), torch.zeros(4, 2, 8, 8), (8, 8), (8, 8), (8, 8),
                              download="raw")
