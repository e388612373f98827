"""Device traces and per-step host/device timing.

Counterpart of ``deep3dpointclouddenoising_tpu/utils/profiling.py``:
:func:`device_trace` records ``torch.profiler`` (CPU and, where a card is
present, CUDA activity) around a block and writes a Chrome trace
(``chrome://tracing``, Perfetto) into a directory, on the coordinator
of a data-parallel run alone; :class:`StepTimer`
splits each step's host clock into host (batch ready) and device (step
done, after ``torch.cuda.synchronize``) segments; :func:`cuda_ms` and
:func:`device_us` time a call on the card by CUDA events and by the
profiler's kernel records (``chip_smoke.py`` and ``compare_host``).
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
# profiler windows device_us takes before it gives up on an empty one
PROFILER_WINDOWS = 5


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


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, kernel: str, iters: int, by_kernel: bool = False,
              expect=()):
    """Device microseconds per call of the CUDA kernels whose name holds
    ``kernel`` ("" for every kernel), from torch.profiler over ``iters``
    calls of ``fn``: for each such kernel the mean over the launches the
    profiler recorded, summed over the kernels (with ``by_kernel``, also
    the means by kernel name).  The profiler does not always record every
    launch of a window (on the H100 machine it once kept 21 of 50, now and
    then none, and once the backward's invert and reduce kernels without
    its main one), so the mean is over those it kept, and a window that
    kept no launch of some kernel named in ``expect`` (or none at all) is
    taken again, up to PROFILER_WINDOWS times.  When no window kept them
    all it raises with ``by_kernel``, and else returns the microseconds
    per call of ``fn`` by CUDA events, noted in ``device_us.by_cuda_events``
    and printed."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_WINDOWS):
        by_name = {}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if kernel in e.name \
                    and e.device_type == torch.autograd.DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(
                    getattr(e, "device_time_total", 0.0))
        if by_name and all(any(x in name for name in by_name)
                           for x in expect):
            break
    else:
        if by_kernel:
            raise AssertionError(
                f"the profiler saw no {kernel} kernel (or not each of "
                f"{expect}) in {PROFILER_WINDOWS} windows")
        # late in a run the profiler can stop keeping kernels for good
        # (seen at phase 11 or 12 of a whole chip_smoke.py run, after some
        # 60-120 windows): CUDA events over the calls instead, every kernel
        # of a call and the gaps between them
        us = cuda_ms(fn, iters, warmup=1) * 1e3
        device_us.by_cuda_events.append({"kernel": kernel, "us": us})
        print(f"device_us: the profiler kept no {kernel} kernel in "
              f"{PROFILER_WINDOWS} windows; CUDA events over {iters} calls "
              f"instead: {us:.2f} us per call", flush=True)
        return us
    means = {name: sum(us) / len(us) for name, us in by_name.items()}
    total = sum(means.values())
    return (total, means) if by_kernel else total


device_us.by_cuda_events = []
