"""DVIS-DAQ online training in stage 2 (the cutter keeps the better half of
its matched queries): two port train steps at B=1 against two of the JAX
package's ``engine/trainer.py::build_train_step``, the JAX draws answered
by site. Bars: every loss rel <= 1e-5, the cutter's gradients rel <= 1e-4
as a norm, the update after the two steps within 1e-4 as a norm, the
frozen segmenter unchanged. The helpers and the rest of the DAQ tests are
in ``tests/test_torch_daq_train.py``; stage 3 has a file of its own, so
that each compiles one JAX executable."""
from tests.test_torch_daq_train import check_two_steps


def test_train_step_matches_jax_in_stage_2():
    check_two_steps(switch=2, stages=(2, 2))
