"""Tracing and profiling (counterpart of geoguessr_ai_tpu/utils/profiling.py)
on ``torch.profiler``: a step-driven profiler that starts and stops its
traces at the JAX package's steps, a whole-region ``trace`` and named
``annotate`` regions.

Each trace is written by ``torch.profiler.tensorboard_trace_handler`` as a
Chrome-trace JSON file (``*.pt.trace.json``) under the log directory; it
needs no tensorboard package.  On a CUDA machine the traces hold the
card's kernels by name.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class ProfileSchedule:
    """Skip ``wait`` steps, then ``warmup``, then trace ``active`` steps,
    ``repeat`` times."""

    wait: int = 2
    warmup: int = 2
    active: int = 10
    repeat: int = 2


def _profile(log_dir: str) -> torch.profiler.profile:
    """A profiler of the host and, where there is one, the card, writing
    its trace into ``log_dir`` when it stops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


class StepProfiler:
    """Step-driven profiler.  The n-th ``step()`` call of a cycle (from 0)
    starts a trace at n = wait + warmup and stops it at n = wait + warmup +
    active - 1; then the next cycle begins, ``repeat`` cycles in all.

    Usage:
        prof = StepProfiler("runs/profile")
        for batch in loader:
            ...
            prof.step()
        prof.close()
    """

    def __init__(self, log_dir: str = "runs/profile",
                 schedule: Optional[ProfileSchedule] = None):
        self.log_dir = log_dir
        self.schedule = schedule or ProfileSchedule()
        self._step = 0
        self._cycle = 0
        self._prof: Optional[torch.profiler.profile] = None
        os.makedirs(log_dir, exist_ok=True)

    def step(self) -> None:
        s = self.schedule
        if self._cycle >= s.repeat:
            return
        start_at = s.wait + s.warmup
        stop_at = start_at + s.active
        if self._step == start_at and self._prof is None:
            self._prof = _profile(self.log_dir)
            self._prof.start()
        self._step += 1
        if self._step >= stop_at and self._prof is not None:
            self._stop()
            self._cycle += 1
            self._step = 0

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self._prof = None

    def close(self) -> None:
        """Stops a trace still running (and writes it)."""
        if self._prof is not None:
            self._stop()


@contextlib.contextmanager
def trace(log_dir: str = "runs/profile"):
    """A trace of the whole region, written into ``log_dir``."""
    os.makedirs(log_dir, exist_ok=True)
    prof = _profile(log_dir)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()


def annotate(name: str):
    """A named region inside a trace."""
    return torch.profiler.record_function(name)
