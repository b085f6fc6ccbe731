"""Logging setup: colored console + plain file handler.

Parity: recbole/utils/logger.py:56-110 — log file lives under
``./log/<model>/<model>-<dataset>-<time>.log`` with ANSI codes stripped for
the file copy.
"""

from __future__ import annotations

import logging
import os
import re

from .common import ensure_dir, get_local_time

_ANSI_RE = re.compile(r"\033\[[0-9;]*m")


class StripColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        return _ANSI_RE.sub("", msg)


def init_logger(config) -> logging.Logger:
    log_root = config["log_root"] or "./log"
    model_name = str(config["model"])
    dir_name = os.path.join(log_root, model_name)
    ensure_dir(dir_name)
    logfile = os.path.join(
        dir_name, f"{model_name}-{config['dataset']}-{get_local_time()}.log"
    )

    level = getattr(logging, str(config["state"] or "INFO").upper(), logging.INFO)

    logger = logging.getLogger()
    logger.setLevel(level)
    # Drop stale handlers so repeated runs in one process don't double-log.
    for h in list(logger.handlers):
        logger.removeHandler(h)

    fmt = "%(asctime)-15s %(levelname)s  %(message)s"
    datefmt = "%a %d %b %Y %H:%M:%S"

    fh = logging.FileHandler(logfile, encoding="utf-8")
    fh.setFormatter(StripColorFormatter(fmt, datefmt))
    fh.setLevel(level)

    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter(fmt, datefmt))
    sh.setLevel(level)

    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger
