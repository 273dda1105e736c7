"""Step-time statistics for the metrics log.

The port's copy of ``mm_training_tpu/utils/profiling.py::StepTimer``. The
device trace (``profile_trace``) waits with ``Trainer.profile``.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

__all__ = ['StepTimer']


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
