"""Device traces and per-step host/device timing.

Counterpart of ``deep3dpointclouddenoising_tpu/utils/profiling.py``:
:func:`device_trace` records ``torch.profiler`` (CPU and, where a card is
present, CUDA activity) around a block and writes a Chrome trace
(``chrome://tracing``, Perfetto) into a directory, on the coordinator
of a data-parallel run alone; :class:`StepTimer`
splits each step's host clock into host (batch ready) and device (step
done, after ``torch.cuda.synchronize``) segments.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile

from ..parallel.dist import is_coordinator

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Trace the block into ``<log_dir>/trace.json`` (no-op if None, and
    on a rank other than a process group's coordinator).  Yields the
    ``torch.profiler.profile`` (or None)."""
    if not log_dir or not is_coordinator():
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


class StepTimer:
    """Per-step host/device timing: call ``host()`` after the input batch is
    ready and ``device(result)`` after the step; ``device`` synchronises
    the card (where ``result`` is a CUDA tensor) so the device segment is
    the real step latency."""

    def __init__(self):
        self.host_s = 0.0
        self.device_s = 0.0
        self.steps = 0
        self._t = time.perf_counter()

    def host(self) -> None:
        now = time.perf_counter()
        self.host_s += now - self._t
        self._t = now

    def device(self, result=None) -> None:
        if isinstance(result, torch.Tensor) and result.is_cuda:
            torch.cuda.synchronize(result.device)
        now = time.perf_counter()
        self.device_s += now - self._t
        self._t = now
        self.steps += 1

    def summary(self) -> Dict[str, float]:
        n = max(self.steps, 1)
        return {"host_ms_per_step": 1000.0 * self.host_s / n,
                "device_ms_per_step": 1000.0 * self.device_s / n,
                "steps": self.steps}
