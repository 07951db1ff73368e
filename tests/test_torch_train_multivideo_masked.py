"""The V=2 train step with the trainer's masked loss against the JAX
package's, over two carried clips with padded and exhausted videos (see
`tests/test_torch_train_multivideo.py`)."""

from test_torch_train_multivideo import two_video_train_step_matches_jax
from test_torch_train_step import few_threads, variables  # noqa: F401


def test_two_video_masked_train_step_matches_jax(variables):  # noqa: F811
    two_video_train_step_matches_jax(variables, masked=True)
