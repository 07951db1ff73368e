"""The ablation zoo's train step against the JAX package's for the four
models that `tests/test_torch_zoo_train.py` leaves to this file: the 3-D
conv blocks (`uavsal_stc3d`, `uavsal_stc2_3d`) and the prior-fed models
(`uavsal_mp`, `uavsal_lstm`, MultiPriors in its train form, and the
ConvLSTM state carried out of the step). The test and its bounds are that
file's; the two files split the names so that each runs in a few minutes
on one test worker."""

import pytest

from test_torch_train_step import few_threads  # noqa: F401
from test_torch_zoo_train import NAMES, STEP_NAMES, train_step_matches_jax


@pytest.mark.parametrize("name", [n for n in NAMES if n not in STEP_NAMES])
def test_zoo_train_step_matches_jax(name):
    train_step_matches_jax(name)
