"""The port's numpy COCO RLE codec: known count strings (from the JAX
package's native codec) and encode/decode round trips."""
import numpy as np
import pytest

from dvis_plus_tpu_torch.evaluation.evaluators import YTVISEvaluator
from dvis_plus_tpu_torch.utils import rle

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
