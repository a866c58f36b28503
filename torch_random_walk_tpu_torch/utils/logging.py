"""Structured logging (the port's copy of
``torch_random_walk_tpu/utils/logging.py``): stdlib logging to stderr, and an
optional JSONL metrics sink that the command-line trainers write.
"""

from __future__ import annotations

import json
import logging
import sys
import time

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def get_logger(name: str = "torch_random_walk_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


class MetricsWriter:
    """Append-only JSONL metrics sink (step metrics, bench results)."""

    def __init__(self, path: str | None):
        self._fh = open(path, "a") if path else None

    def emit(self, **metrics):
        record = {"ts": time.time(), **metrics}
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        return record

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
