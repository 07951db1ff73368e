"""Scalar logging for training (own copy of `iip_uavsal_saliency_tpu/utils/
metrics_log.py`): one JSON object per line, `{"tag", "value", "wall"[,
"step"]}`, in `<log_dir>/<name>.jsonl`, mirrored to TensorBoard when
tensorboardX or torch.utils.tensorboard can be imported. Neither is needed."""

from __future__ import annotations

import importlib
import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "metrics"):
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, f"{name}.jsonl")
        self._f = open(self._path, "a", buffering=1)
        self._tb = None
        for mod in ("tensorboardX", "torch.utils.tensorboard"):
            try:
                self._tb = importlib.import_module(mod).SummaryWriter(log_dir)
                break
            except Exception:  # noqa: BLE001 -- the mirror is optional
                continue

    @property
    def path(self) -> str:
        return self._path

    def scalar(self, tag: str, value: float, step: Optional[int] = None) -> None:
        rec = {"tag": tag, "value": float(value), "wall": time.time()}
        if step is not None:
            rec["step"] = int(step)
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
