"""Per-dispatch serving latency: request->response percentiles (counterpart
of `iip_uavsal_saliency_tpu/runners/latency.py`).

Throughput figures sync once per timed loop; they say nothing about what
one caller waits for one clip. A real-time UAV consumer cares about
request->response: dispatch the clip, get the saliency map back on the
host. That round trip is what this measures, per dispatch, over enough
dispatches for the tail to mean something.

Methodology:
- each dispatch is synced by fetching the saliency to the host (`.cpu()`,
  which waits for the step on the card): a serving caller needs the map on
  the host anyway, so the fetch is part of the latency;
- the carried recurrent state stays on the device and chains forward
  (true streaming; a graphed step's returned state is its static buffer,
  which it takes back as the next state);
- no trimming: stalls land in the recorded samples, and the percentile
  summary reports them.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np


def measure_dispatch_latency(step, x, state, *, n: int = 1000,
                             warmup: int = 20) -> List[float]:
    """Per-dispatch request->response seconds for `step(x, state) ->
    (out, state)` over `n` chained dispatches (state flows forward; the
    output is fetched to the host every step)."""
    out, st = step(x, state)
    out.cpu()  # first call (a graph's capture, the kernels' build) + first fetch
    for _ in range(warmup):
        out, st = step(x, st)
    out.cpu()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out, st = step(x, st)
        out.cpu()  # host fetch = the response the caller waits for
        times.append(time.perf_counter() - t0)
    return times


def latency_summary(times_s: List[float], frames_per_dispatch: int) -> Dict:
    """Percentile summary in ms/dispatch + the sustained FPS implied by the
    mean (sum/n): p50 is the typical wait, p99/max carry the stall tail,
    `fps_sustained` is what the same loop delivers as throughput."""
    a = np.asarray(times_s, np.float64) * 1e3
    q = lambda p: float(np.percentile(a, p))  # noqa: E731
    return {
        "n": int(a.size),
        "p50_ms": round(q(50), 3),
        "p90_ms": round(q(90), 3),
        "p95_ms": round(q(95), 3),
        "p99_ms": round(q(99), 3),
        "max_ms": round(float(a.max()), 3),
        "mean_ms": round(float(a.mean()), 3),
        "fps_sustained": round(frames_per_dispatch / (a.mean() / 1e3), 1),
    }
