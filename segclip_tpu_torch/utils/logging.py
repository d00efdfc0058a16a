"""Singleton logger writing to stderr + <output_dir>/log.txt and a jsonl
metric writer (a copy of segclip_tpu/utils/logging.py, under the port's
logger name; replaces reference util.py:63-93 and adds structured
metrics)."""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional

_LOGGER: Optional[logging.Logger] = None


_FMT = logging.Formatter("%(asctime)s %(levelname)s %(message)s",
                         "%Y-%m-%d %H:%M:%S")


def get_logger(output_dir: Optional[str] = None,
               name: str = "segclip_tpu_torch") -> logging.Logger:
    """Returns the singleton logger. When `output_dir` is given, a
    <output_dir>/log.txt FileHandler is attached if that file isn't already
    a target — so a library-mode caller (tests, notebooks, sequential CLI
    mains in one process) that first logged without a dir still gets its
    log file later."""
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger(name)
        logger.setLevel(logging.INFO)
        logger.propagate = False
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(_FMT)
        logger.addHandler(sh)
        _LOGGER = logger
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(output_dir, "log.txt"))
        if path not in {getattr(h, "baseFilename", None)
                        for h in _LOGGER.handlers}:
            # one log file at a time: detach previous runs' file handlers
            # so sequential in-process runs don't append to each other's
            # log.txt (and FDs don't accumulate)
            for h in [h for h in _LOGGER.handlers
                      if isinstance(h, logging.FileHandler)]:
                _LOGGER.removeHandler(h)
                h.close()
            fh = logging.FileHandler(path)
            fh.setFormatter(_FMT)
            _LOGGER.addHandler(fh)
    return _LOGGER


class MetricWriter:
    """Appends one JSON object per line to <output_dir>/metrics.jsonl."""

    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")

    def write(self, step: int, **metrics) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "item") or
                        isinstance(v, (int, float)) else v)
                    for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
