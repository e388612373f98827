"""Running meters of the training loop.

Counterpart of ``AverageMeter`` in
``deep3dpointclouddenoising_tpu/utils/metrics.py``.
"""
from __future__ import annotations


class AverageMeter:
    """The last value and the running weighted average."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
