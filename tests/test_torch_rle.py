"""The port's COCO RLE codec (``utils/rle.py``, the native C++ codec the
evaluation uses on every device) and its numpy twin (``utils/rle_numpy.py``):
known count strings (from the JAX package's codec), encode/decode round
trips, and string for string the same as each other and as the JAX
package's codec on random, empty, full, one-row and odd-width masks, from
a mask, from its packed rows and from its per-column change rows (with the
overflow that returns None). A failed build raises; a build writes under a
private name and renames into place."""
import os
import sys
import threading

import numpy as np
import pytest

from dvis_plus_tpu.utils import rle as jax_rle
from dvis_plus_tpu_torch.evaluation.evaluators import YTVISEvaluator
from dvis_plus_tpu_torch.utils import rle, rle_numpy

MASK_5x7 = [
    [0, 1, 0, 1, 1, 1, 1],
    [0, 0, 0, 1, 1, 0, 0],
    [0, 1, 0, 0, 1, 0, 1],
    [1, 0, 1, 1, 0, 1, 1],
    [1, 0, 0, 0, 0, 0, 0],
]


def _box_mask():
    m = np.zeros((40, 33), bool)
    m[3:30, 5:20] = True
    m[0, 0] = True  # starts with a foreground run
    return m


@pytest.mark.parametrize(
    "mask,counts",
    [
        (np.asarray(MASK_5x7, bool), b"331N40L10O021N00O0010"),
        (_box_mask(), b"01Z6j0SJ000000000000000000000000000U`0"),
    ],
)
def test_known_count_strings(mask, counts):
    assert rle.encode(mask) == {"size": list(mask.shape), "counts": counts}
    assert rle.encode_packed(np.packbits(mask, axis=-1), *mask.shape)["counts"] == counts


@pytest.mark.parametrize("shape,density", [((1, 1), 0.5), ((37, 53), 0.5), ((720, 96), 0.02),
                                           ((16, 16), 0.0), ((16, 16), 1.0)])
def test_round_trip(shape, density):
    mask = np.random.RandomState(0).rand(*shape) < density
    np.testing.assert_array_equal(rle.decode(rle.encode(mask)), mask)


def test_evaluator_rows_from_packed_masks(tmp_path):
    m = np.zeros((2, 3, 9, 11), bool)
    m[0, 1, 2:5, 3:8] = True
    ev = YTVISEvaluator("synthetic", str(tmp_path), contiguous_to_dataset_id={4: 17})
    ev.process(7, {"pred_scores": [0.9, 0.1], "pred_labels": [4, 0],
                   "pred_masks": rle.PackedMasks(np.packbits(m, axis=-1), 9, 11)})
    rows = ev.predictions
    assert [r["category_id"] for r in rows] == [17, 1]
    assert rows[0]["segmentations"][0] is None and rows[1]["segmentations"] == [None] * 3
    seg = rows[0]["segmentations"][1]
    np.testing.assert_array_equal(rle.decode(seg), m[0, 1])
    assert (tmp_path / "results.json").samefile(ev.write_results())


def _cases():
    rng = np.random.RandomState(9)
    yield "random", rng.rand(37, 53) < 0.5
    yield "sparse_tall", rng.rand(720, 96) < 0.02
    yield "empty", np.zeros((16, 16), bool)
    yield "full", np.ones((16, 16), bool)
    yield "one_row", rng.rand(1, 13) < 0.5
    yield "one_column", rng.rand(11, 1) < 0.5
    blob = np.zeros((30, 21), bool)
    blob[4:20, 3:17] = True
    blob[0, 0] = blob[29, 20] = True
    yield "blob_odd_width", blob


CASES = dict(_cases())


def _colruns(mask):
    """The per-column change rows, counts, packed boundary bits and pixel
    (0, 0) of a mask, as the device's runs download gives them."""
    h, w = mask.shape
    d = mask[1:] != mask[:-1]
    m_col = d.sum(0).astype(np.uint16)
    k = max(int(m_col.max(initial=0)), 1)
    rows = np.full((w, k), h + 1, np.uint16)
    for c in range(w):
        r = np.flatnonzero(d[:, c]) + 1
        rows[c, : len(r)] = r
    jump = np.zeros(w, np.uint8)
    jump[1:] = mask[0, 1:] != mask[h - 1, :-1]
    return rows, m_col, np.packbits(jump), bool(mask[0, 0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_twin_and_jax_codecs_agree(name):
    mask = CASES[name]
    h, w = mask.shape
    want = jax_rle.encode(mask)["counts"]
    packed = np.packbits(mask, axis=-1)
    for codec in (rle, rle_numpy):
        assert codec.encode(mask) == {"size": [h, w], "counts": want}, codec.__name__
        assert codec.encode_packed(packed, h, w)["counts"] == want, codec.__name__
        np.testing.assert_array_equal(codec.decode({"size": [h, w], "counts": want}), mask)
        assert codec.area({"size": [h, w], "counts": want}) == int(mask.sum())
    if h > 1:
        rows, m_col, jumps, first = _colruns(mask)
        for fn in (rle.encode_colruns, rle_numpy.encode_colruns, jax_rle.encode_colruns):
            assert fn(rows, m_col, jumps, first, h, w)["counts"] == want, fn.__module__


@pytest.mark.parametrize("name", ["random", "blob_odd_width"])
def test_colruns_overflow_returns_none(name):
    """A column with more changes than the k slots: every codec returns None,
    so the caller encodes that frame from its packed pixels."""
    mask = CASES[name]
    rows, m_col, jumps, first = _colruns(mask)
    rows = np.ascontiguousarray(rows[:, :1])  # k = 1
    assert m_col.max() > 1
    for fn in (rle.encode_colruns, rle_numpy.encode_colruns, jax_rle.encode_colruns):
        assert fn(rows, m_col, jumps, first, *mask.shape) is None, fn.__module__


def test_merge_agrees_with_the_twin():
    rng = np.random.RandomState(10)
    masks = [rng.rand(19, 27) < 0.4 for _ in range(3)]
    rles = [rle.encode(m) for m in masks]
    for intersect in (False, True):
        assert rle.merge(rles, intersect) == rle_numpy.merge(rles, intersect)
        assert rle.merge(rles, intersect)["counts"] == jax_rle.merge(rles, intersect)["counts"]


def test_codec_build_is_private_then_renamed_and_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(rle, "BUILD_DIR", str(tmp_path))
    so = rle.build()
    assert os.path.dirname(so) == str(tmp_path) and os.listdir(tmp_path) == [os.path.basename(so)]
    assert rle.build() == so  # built once, then reused
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(rle, "SOURCE", str(broken))
    with pytest.raises(RuntimeError, match="building the RLE codec failed"):
        rle.build()


def test_concurrent_first_builds_leave_one_library(monkeypatch, tmp_path):
    """Sixteen threads build into an empty directory at once (the eval
    worker and the main thread may both encode first): one library, no
    half-written file, every thread loads the same path."""
    monkeypatch.setattr(rle, "BUILD_DIR", str(tmp_path))
    paths, errors = [], []

    def build():
        try:
            paths.append(rle.build())
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=build) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(paths) == 16 and len(set(paths)) == 1
    assert os.listdir(tmp_path) == [os.path.basename(paths[0])]
