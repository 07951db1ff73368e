"""The port's latency runner and profiling helpers against the JAX
package's: `latency_summary` on the same samples (a stall tail included,
nothing trimmed), `measure_dispatch_latency` over a stub step (the state
chained, one host fetch per dispatch), `StageTimer`'s report on the same
clock, and `trace_profile`'s trace file."""

import json
import os

import numpy as np
import pytest
import torch

from iip_uavsal_saliency_tpu.runners import latency as jlatency
from iip_uavsal_saliency_tpu.utils import profiling as jprofiling
from iip_uavsal_saliency_tpu_torch.runners import latency as tlatency
from iip_uavsal_saliency_tpu_torch.utils import profiling as tprofiling
from test_torch_train_step import few_threads  # noqa: F401


@pytest.mark.parametrize("n,frames", [(1000, 20), (7, 80), (1, 5)])
def test_latency_summary_matches_jax(n, frames):
    """Lognormal dispatch times with a few stalls of 10x to 100x: the same
    percentiles, max, mean and sustained FPS, to the JAX package's
    rounding; the tail is kept (max is the largest stall)."""
    rng = np.random.RandomState(n)
    times = list(rng.lognormal(np.log(0.016), 0.05, n))
    for i in rng.choice(n, size=min(3, n), replace=False):
        times[i] *= rng.uniform(10, 100)
    got = tlatency.latency_summary(times, frames)
    assert got == jlatency.latency_summary(times, frames)
    assert got["n"] == n and got["max_ms"] == round(max(times) * 1e3, 3)


class _Fetched:
    """A stub output whose host fetches are counted."""

    fetches = 0

    def cpu(self):
        _Fetched.fetches += 1
        return self


def test_measure_dispatch_latency_chains_state_and_fetches_each_dispatch():
    """The state each call returns is the next call's; one warm-up call,
    `warmup` more, then `n` timed dispatches, each ending in a host fetch
    (`n` + 2 fetches in all: after the first call and after the warm-up)."""
    seen = []

    def step(x, state):
        seen.append(state)
        return _Fetched(), state + 1

    _Fetched.fetches = 0
    times = tlatency.measure_dispatch_latency(step, "clip", 0, n=25, warmup=4)
    assert len(times) == 25 and all(t >= 0 for t in times)
    assert seen == list(range(1 + 4 + 25))
    assert _Fetched.fetches == 25 + 2


def test_measure_dispatch_latency_on_a_tensor_step():
    state = torch.zeros(2)
    times = tlatency.measure_dispatch_latency(lambda x, s: (x * s.sum(), s + 1), torch.ones(3),
                                              state, n=5, warmup=2)
    assert len(times) == 5 and not state.any()


def test_stage_timer_reports_as_jax(monkeypatch):
    """The same stages on the same clock give the same report."""
    def clock():
        ticks = iter(np.arange(0.0, 100.0, 0.25))
        return lambda: float(next(ticks))

    reports = []
    for module in (jprofiling, tprofiling):
        monkeypatch.setattr(module.time, "perf_counter", clock())
        timer = module.StageTimer()
        for stage in ("decode", "step", "step", "write", "step"):
            with timer(stage):
                pass
        with pytest.raises(RuntimeError):
            with timer("failed"):
                raise RuntimeError
        reports.append(timer.report())
    assert reports[0] == reports[1]
    assert "step" in reports[1] and "x3" in reports[1] and "failed" in reports[1]


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    """A `torch.profiler` trace of what runs inside, as a Chrome trace
    (what Perfetto opens), with the profiler's sums by name."""
    with tprofiling.trace_profile(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(tmp_path, "trace", "trace.json")) as f:
        trace = json.load(f)
    assert any("mm" in str(e.get("name", "")) for e in trace["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())
