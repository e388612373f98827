"""Run logs: ``log.txt`` and the scalar log ``metrics.jsonl``.

Counterpart of ``deep3dpointclouddenoising_tpu/utils/logger.py``, with the
same file names and the same JSONL schema (``{"tag", "value", "step"}`` a
line), so ``scripts/plot_metrics.py`` reads the port's logs as they are.
In a data-parallel run only the coordinator writes them
(``scripts/train.py:335,353``); the other ranks log to stdout alone,
each line under ``[rank r]``.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import sys

from ..parallel.dist import is_coordinator, rank

LOGGER_NAME = "d3pcd_torch"


class _StdoutHandler(logging.StreamHandler):
    """Writes to whatever ``sys.stdout`` is at each record (a test's
    capture included), not the stream of the first call."""

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):
        pass


def close_logger(logger: logging.Logger) -> None:
    """Detach and close every handler of ``logger``."""
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()


def setup_logger(output: str) -> logging.Logger:
    """The entry points' logger: each message to stdout as it is, and to
    ``<output>/log.txt`` after a time stamp, appended.

    Not cached: each call replaces the logger's handlers, so the runs of
    one process each write their own ``log.txt``, and stdout is whatever
    ``sys.stdout`` is at each message.  On a rank other than the
    coordinator of a process group, stdout alone, each message after
    ``[rank r]``.
    """
    logger = get_logger()
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    close_logger(logger)
    handler = _StdoutHandler()
    coordinator = is_coordinator()
    handler.setFormatter(logging.Formatter(
        "%(message)s" if coordinator else f"[rank {rank()}] %(message)s"))
    logger.addHandler(handler)
    if not coordinator:
        return logger
    os.makedirs(output, exist_ok=True)
    handler = logging.FileHandler(os.path.join(output, "log.txt"))
    handler.setFormatter(logging.Formatter(
        "[%(asctime)s] %(name)s %(levelname)s: %(message)s",
        datefmt="%m/%d %H:%M:%S"))
    logger.addHandler(handler)
    return logger


def get_logger() -> logging.Logger:
    """The entry points' logger, as the last :func:`setup_logger` left
    it."""
    return logging.getLogger(LOGGER_NAME)


class MetricsWriter:
    """Scalar log: append-only JSONL always, plus TensorBoard event files
    under ``<log_dir>/tb/`` where ``torch.utils.tensorboard`` imports (it
    needs the ``tensorboard`` package).  The JSONL is the source of
    truth.  A resumed run appends to the same file, so a step may appear
    twice; ``scripts/plot_metrics.load_metrics`` keeps the last."""

    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._f.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._f.close()


@contextlib.contextmanager
def run_logs(run_dir: str, metrics: bool = True):
    """``(logger, writer)`` of one run: :func:`setup_logger` into
    ``run_dir`` and, with ``metrics`` on the coordinator, a
    :class:`MetricsWriter` there (else ``None``); both closed when the
    block ends."""
    logger = setup_logger(run_dir)
    writer = MetricsWriter(run_dir) if metrics and is_coordinator() \
        else None
    try:
        yield logger, writer
    finally:
        if writer is not None:
            writer.close()
        close_logger(logger)
