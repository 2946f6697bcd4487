"""Run logging: stdout / stderr teed to a per-run log file (port of
diffpure_tpu/utils/logging.py; ref utils.py:38-94, eval_sde_adv.py:289-298)."""
from __future__ import annotations

import logging
import os
import sys


class Logger:
    """Tee a stream to a file (ref utils.py:38-94)."""

    def __init__(self, stream, path: str):
        self.stream = stream
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.file = open(path, "a")

    def write(self, data):
        self.stream.write(data)
        self.file.write(data)
        self.file.flush()

    def flush(self):
        self.stream.flush()
        self.file.flush()

    def close(self):
        self.file.close()

    def __getattr__(self, name):
        return getattr(self.stream, name)


def setup_run_logging(log_dir: str, verbose: str = "info") -> None:
    """Tee stdout and stderr to <log_dir>/log.txt and configure the logging
    module at level ``verbose``."""
    level = getattr(logging, verbose.upper(), None)
    if not isinstance(level, int):
        raise ValueError(f"level {verbose} not supported")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "log.txt")
    sys.stdout = Logger(sys.stdout, path)
    sys.stderr = Logger(sys.stderr, path)

    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "%(levelname)s - %(filename)s - %(asctime)s - %(message)s"))
    logger = logging.getLogger()
    logger.addHandler(handler)
    logger.setLevel(level)
