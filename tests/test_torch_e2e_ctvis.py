"""CTVIS (MinVIS with the ReID branch) end to end: the port's CLI (``--device cpu``) and
``train_net_video.py --eval-only`` on ``configs/dvis/ctvis_r50_ytvis19.yaml``
with the tiny overrides of ``tests/test_torch_common.py::E2E_TINY``, the same
seeded weights, on the synthetic YouTube-VIS set: at the JAX package's
default eval settings (``runs`` download, threaded pipeline, the ``auction`` matcher)
and with the packed download and the plain loop. The results.json rows are
equal row for row: ids, categories and RLE strings; scores rel 1e-4."""
import pytest

from tests.test_torch_common import assert_rows_equal, e2e_rows


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    return str(tmp_path_factory.mktemp("e2e_ctvis"))


@pytest.mark.parametrize("setting", ["defaults", "packed_plain"])
def test_cli_rows_equal_jax_cli(shared, setting):
    got, want = e2e_rows("ctvis", shared, setting)
    assert_rows_equal(got, want)
