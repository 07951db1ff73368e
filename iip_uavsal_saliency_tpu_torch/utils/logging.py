"""Leveled stderr loggers (own copy of `iip_uavsal_saliency_tpu/utils/
logging.py::get_logger`). The level comes from UAVSAL_LOGLEVEL (INFO)."""

from __future__ import annotations

import logging
import os
import sys


def get_logger(name: str = "uavsal") -> logging.Logger:
    logger = logging.getLogger(f"uavsal_torch.{name}")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname).1s: %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("UAVSAL_LOGLEVEL", "INFO"))
        logger.propagate = False
    return logger
