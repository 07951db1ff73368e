"""`parallel.spawn`'s two limits on the CPU: `timeout_s` bounds a
collective's wait for its peers and never the run, so ranks that work
longer than it between collectives finish (a `cli train --dp_devices`
run takes hours under the default timeout); `deadline_s`, where a caller
gives one, ends the whole run."""

import time

import pytest

from iip_uavsal_saliency_tpu_torch.parallel import spawn
from _dp_runs import sleep_then_sum
from test_torch_train_step import few_threads  # noqa: F401


def test_ranks_outlive_the_collective_timeout():
    t0 = time.monotonic()
    got = spawn(sleep_then_sum, 2, "gloo", (7.0,), timeout_s=5, threads=1)
    assert got == [3.0, 3.0]
    assert time.monotonic() - t0 >= 7.0


def test_a_deadline_ends_every_rank():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="2 of 2 ranks failed or timed out"):
        spawn(sleep_then_sum, 2, "gloo", (600.0,), timeout_s=5, threads=1, deadline_s=3)
    assert time.monotonic() - t0 < 60
