"""Port VIS post-processing against the JAX functions: flat top-K, two-stage
mask upsampling (both an upsampling and a downsampling second stage), and
the bit-packed download. Packed bits must be identical except at pixels
whose JAX pre-threshold value is within 1e-4 of the threshold."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvis_plus_tpu.engine.inference import _packbits as jax_packbits
from dvis_plus_tpu.engine.inference import paged_inference_video as jax_paged
from dvis_plus_tpu.models.meta.dvis_online import inference_video_vis as jax_video_vis
from dvis_plus_tpu.models.meta.minvis import topk_select as jax_topk
from dvis_plus_tpu_torch.models.meta.dvis_online import inference_video_vis
from dvis_plus_tpu_torch.engine.inference import _packbits, paged_inference_video
from dvis_plus_tpu_torch.models.meta.minvis import topk_select, upsample_masks
from dvis_plus_tpu_torch.utils.rle import PackedMasks

torch.set_num_threads(2)

# (img_size, output_size, padded_size): second stage up, down, mixed
SIZES = {
    "up": ((60, 56), (90, 112), (64, 64)),
    "down": ((60, 60), (37, 53), (64, 64)),
    "mixed": ((48, 64), (30, 100), (64, 64)),
}


def _jax_prethreshold(masks, img_size, output_size, padded_size):
    """The JAX ``upsample_masks`` chain before its > 0 threshold."""
    N, t = masks.shape[:2]
    x = jax.image.resize(jnp.asarray(masks), (N, t, *padded_size), method="bilinear")
    x = x[:, :, : img_size[0], : img_size[1]]
    return np.asarray(jax.image.resize(x, (N, t, *output_size), method="bilinear"))


def _assert_bits_match(got_bool, pre):
    want = pre > 0
    differ = got_bool != want
    assert np.all(np.abs(pre[differ]) < 1e-4), np.abs(pre[differ]).max()
    assert differ.mean() < 1e-3


@pytest.mark.parametrize("aux", [False, True])
def test_topk_select_matches_jax(aux):
    rng = np.random.RandomState(int(aux))
    logits = rng.randn(12, 6).astype(np.float32)
    aux_logits = rng.randn(12, 6).astype(np.float32) if aux else None
    s, l, q = topk_select(
        torch.from_numpy(logits), 7, None if aux_logits is None else torch.from_numpy(aux_logits)
    )
    js, jl, jq = jax_topk(
        jnp.asarray(logits), 7, None if aux_logits is None else jnp.asarray(aux_logits)
    )
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def _tied_logits(seed):
    """Logits whose softmax saturates to exactly 1.0 in more (query, class)
    cells than the top-K keeps, scattered so that the kept ones are not the
    first rows, plus a second group of exactly equal smaller scores."""
    rng = np.random.RandomState(seed)
    Q, K1 = 16, 7
    logits = rng.randn(Q, K1).astype(np.float32)
    for q in (1, 3, 4, 8, 9, 12, 13, 15):  # eight saturated cells, K keeps five
        logits[q] = -60.0
        logits[q, rng.randint(K1 - 1)] = 60.0
    logits[0] = 0.0
    logits[0, 2] = 4.0  # about 0.9: above every random row, below the saturated
    logits[[2, 6, 10]] = logits[0]  # four equal rows: equal unsaturated scores too
    return logits


@pytest.mark.parametrize("topk", [5, 11])
@pytest.mark.parametrize("aux", [False, True])
def test_topk_select_breaks_ties_as_jax(aux, topk):
    """Equal scores across the K-th place: ``jax.lax.top_k`` returns the lower
    flat index first, and so must the port, element for element (K = 5 cuts
    the eight scores of exactly 1.0; K = 11 cuts a group of equal smaller
    ones). With ``aux`` the ties come from the element-wise maximum of two
    saturated softmaxes, the offline path's fusion."""
    logits = _tied_logits(7)
    aux_logits = np.roll(_tied_logits(8), 1, axis=0) if aux else None
    s, l, q = topk_select(
        torch.from_numpy(logits), topk, None if aux_logits is None else torch.from_numpy(aux_logits)
    )
    js, jl, jq = jax_topk(
        jnp.asarray(logits), topk, None if aux_logits is None else jnp.asarray(aux_logits)
    )
    more = np.asarray(jax_topk(
        jnp.asarray(logits), topk + 1, None if aux_logits is None else jnp.asarray(aux_logits))[0])
    assert more[topk - 1] == more[topk] and (more[:5] == 1.0).all()  # the cut falls inside a tie
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.mark.parametrize("case", sorted(SIZES))
def test_upsample_masks_matches_jax(case):
    img, out, pad = SIZES[case]
    masks = np.random.RandomState(2).randn(3, 4, 16, 16).astype(np.float32)
    got = upsample_masks(torch.from_numpy(masks), img, out, pad).numpy()
    pre = _jax_prethreshold(masks, img, out, pad)
    assert got.shape == pre.shape
    _assert_bits_match(got, pre)


def test_packbits_matches_jax():
    x = np.random.RandomState(3).rand(2, 3, 5, 21) > 0.5
    np.testing.assert_array_equal(
        _packbits(torch.from_numpy(x)).numpy(), np.asarray(jax_packbits(jnp.asarray(x)))
    )
    np.testing.assert_array_equal(_packbits(torch.from_numpy(x)).numpy(), np.packbits(x, -1))


def test_paged_inference_video_matches_jax():
    rng = np.random.RandomState(4)
    Q, K1, T = 12, 6, 11
    logits = rng.randn(Q, K1).astype(np.float32)
    masks = rng.randn(Q, T, 16, 16).astype(np.float32)
    img, out, pad = SIZES["down"]
    s, l, pm = paged_inference_video(
        torch.from_numpy(logits), torch.from_numpy(masks), img, out, pad, topk=7, chunk=4,
        download="packed",
    )
    js, jl, jpm = jax_paged(
        jnp.asarray(logits), jnp.asarray(masks), img, out, pad, topk=7, chunk=4,
        download="packed",
    )
    assert isinstance(pm, PackedMasks) and pm.shape == jpm.shape
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))
    _, _, jq = jax_topk(jnp.asarray(logits), 7)
    _assert_bits_match(pm.unpack(), _jax_prethreshold(masks[np.asarray(jq)], img, out, pad))


def test_inference_video_vis_matches_jax():
    rng = np.random.RandomState(5)
    logits = rng.randn(10, 4).astype(np.float32)
    masks = rng.randn(10, 3, 16, 16).astype(np.float32)
    img, out, pad = SIZES["mixed"]
    s, l, m = inference_video_vis(torch.from_numpy(logits), torch.from_numpy(masks), img, out, pad, topk=6)
    want = jax_video_vis(jnp.asarray(logits), jnp.asarray(masks), img, out, pad, topk=6)
    np.testing.assert_allclose(s.numpy(), np.asarray(want.scores), rtol=1e-6)
    np.testing.assert_array_equal(l.numpy(), np.asarray(want.labels))
    _, _, jq = jax_topk(jnp.asarray(logits), 6)
    _assert_bits_match(m.numpy(), _jax_prethreshold(masks[np.asarray(jq)], img, out, pad))
