"""Profiling: per-stage wall timers and device traces (counterpart of
`iip_uavsal_saliency_tpu/utils/profiling.py`).

A context-manager stage timer with aggregate reporting, and `trace_profile`,
a `torch.profiler` trace (CPU, and CUDA where there is a card) written as a
Chrome trace that Perfetto opens, standing in for `jax.profiler.trace`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageTimer:
    """Accumulates wall time per named stage.

    with timer("decode"): ...
    print(timer.report())
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

    def report(self) -> str:
        lines = ["stage timing", "-" * 46]
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{k:<24s} {self.totals[k]:9.3f}s  x{self.counts[k]:<6d}"
                f" {self.totals[k] / max(self.counts[k], 1) * 1e3:8.2f} ms/call"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace_profile(log_dir: str) -> Iterator[object]:
    """Trace what runs inside: `with trace_profile("build/trace") as prof:
    step(...)`. Writes `<log_dir>/trace.json` (Chrome trace format, for
    Perfetto) when the block ends; `prof` is the `torch.profiler.profile`,
    whose `key_averages()` sum the events by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
