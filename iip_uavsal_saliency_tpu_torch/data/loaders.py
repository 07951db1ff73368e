"""Background decode (own copy of `iip_uavsal_saliency_tpu/data/loaders.py::
_prefetched`)."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Sequence


def _prefetched(items: Sequence, load: Callable, prefetch: int) -> Iterator:
    """`load(item)` for each item, computed up to `prefetch` items ahead on
    a daemon thread. An exception in the thread is raised in the consumer:
    a dead producer must not look like the end of the data."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    stop = object()

    def producer():
        try:
            for it in items:
                q.put(load(it))
            q.put(stop)
        except BaseException as e:  # noqa: BLE001 -- handed to the consumer
            q.put(e)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
