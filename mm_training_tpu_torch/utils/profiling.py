"""Profiling and tracing: the device trace and step-time statistics.

The port of ``mm_training_tpu/utils/profiling.py``: ``profile_trace``
(:21-35) captures a trace with ``torch.profiler`` in place of the JAX
profiler, the host's CPU activity always and the card's CUDA activity when
the process has one, written as a Chrome trace (``trace.json``, viewable in
Perfetto or chrome://tracing); ``StepTimer`` aggregates step-time
percentiles for the metrics log.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

__all__ = ['TRACE_FILE', 'StepTimer', 'profile_trace']

TRACE_FILE = 'trace.json'


@contextlib.contextmanager
def profile_trace(out_dir: str, cuda: bool):
    """Capture a trace of the ``with`` body under ``out_dir`` as
    ``trace.json``; yields the ``torch.profiler.profile`` object. ``cuda``
    adds the card's activity (the body runs on the card). Usage: ``with
    profile_trace(out / 'profile', cuda=True): run_steps()``; the body ends
    with a host read of its last result, so the trace holds the device
    work."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(out_dir) / TRACE_FILE))


class StepTimer:
    """Rolling step-time stats (p50/p90/max, samples/sec) on the host clock.
    A step's time is what the caller waited: ``stop`` follows the host's
    read of the step's result."""

    def __init__(self, window: int = 200):
        self.window = window
        self._times = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_samples: int = 1) -> float:
        if self._t0 is None:
            raise RuntimeError('StepTimer.stop before start')
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._times.append((dt, n_samples))
        if len(self._times) > self.window:
            self._times.pop(0)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        ts = np.asarray([t for t, _ in self._times])
        ns = np.asarray([n for _, n in self._times])
        return {
            'step_time_p50': float(np.percentile(ts, 50)),
            'step_time_p90': float(np.percentile(ts, 90)),
            'step_time_max': float(ts.max()),
            'samples_per_sec': float(ns.sum() / ts.sum()),
        }
