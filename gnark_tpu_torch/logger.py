"""Structured logging (reference logger/: zerolog global with console
writer, Nop under tests). Python logging with structured key-value
fields on compile/solve/prove events."""

from __future__ import annotations

import logging
import os
import time


def get_logger(name: str = "gnark_tpu") -> logging.Logger:
    log = logging.getLogger(name)
    if not log.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).3s %(name)s %(message)s", "%H:%M:%S"))
        log.addHandler(h)
        level = os.environ.get("GNARK_TPU_LOG", "WARNING").upper()
        log.setLevel(getattr(logging, level, logging.WARNING))
    return log


def kv(**fields) -> str:
    return " ".join(f"{k}={v}" for k, v in fields.items())


class timed:
    """with timed() as t: ...; t.ms -> elapsed milliseconds."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self.t0) * 1e3
        return False
