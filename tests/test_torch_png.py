"""The port's PNG writer (``dvis_plus_tpu_torch/utils/png.py``): its files
decode through OpenCV to the array written, for grayscale and RGB images,
odd widths and a one-pixel image; its own reader gives the same array back
and refuses what it does not read."""
import cv2
import numpy as np
import pytest

from dvis_plus_tpu_torch.utils import png


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (48, 853), (1, 1, 3), (5, 11, 3), (37, 41, 3)])
def test_written_png_decodes_to_the_array(tmp_path, shape):
    img = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        got = got[:, :, ::-1]  # OpenCV reads BGR
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_reader_refuses_other_files(tmp_path):
    img = np.arange(60, dtype=np.uint8).reshape(5, 12)
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, img)  # libpng chooses its own row filters
    with pytest.raises(ValueError):
        png.read_png(path)
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "y.png"), np.zeros((3, 4, 2), np.uint8))
    (tmp_path / "z.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        png.read_png(str(tmp_path / "z.png"))
