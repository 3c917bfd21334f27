"""DVIS-DAQ online training in stage 3 (the cutter keeps every query that
scores above ``training_select_thr``, and the slot branch is taught
disappearances): two port train steps at B=1 against two of the JAX
package's ``engine/trainer.py::build_train_step``, the JAX draws answered
by site (bars as ``tests/test_torch_daq_train_stage2.py``); then a batch
of two clips, whose losses and gradients are the mean of the JAX step's
over each clip alone, each clip's mask losses divided by the batch's mean
matched count (1e-5, 1e-4 as a norm): what the reference's one clip a GPU
under DDP gives, its criterion's count all-reduced, where the JAX step
trains the first clip alone."""
from tests.test_torch_daq_train import check_two_clips, check_two_steps


def test_train_step_matches_jax_in_stage_3():
    check_two_steps(switch=0, stages=(3, 3))


def test_two_clips_give_the_mean_of_the_jax_clips():
    check_two_clips(switch=0)
