"""The resume tests of `tests/test_torch_train_resume.py` with the default
freeze list and no weight decay."""

from test_torch_train_resume import (case, dataset, test_jax_resumes_a_port_run,  # noqa: F401
                                     test_opt_state_has_the_jax_layout,
                                     test_port_resumes_a_jax_run,
                                     test_the_ports_own_earlier_layout_still_resumes)
from test_torch_train_step import FREEZE, few_threads, variables  # noqa: F401

CASE = (FREEZE, 0.0)
