"""The port's train step against the JAX package's with the default freeze
mask ('trunk/sfnet', 'trunk/st_layer'): the comparison of
`tests/test_torch_train_step.py`, in a file of its own so that it compiles in
another worker. The frozen parameters take no gradient and do not move; their
BatchNorm running stats still do."""

from test_torch_train_step import FREEZE, few_threads, train_step_matches_jax, variables  # noqa: F401


def test_train_step_with_default_freeze_matches_jax(variables):  # noqa: F811
    train_step_matches_jax(variables, FREEZE)
