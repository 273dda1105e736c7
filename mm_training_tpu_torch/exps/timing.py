"""Timing helpers for the card (CUDA events and the host clock)."""
from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ['device_ms', 'host_ms']


def device_ms(fn: Callable[[], object], iters: int) -> float:
    """Device time of one call: ``iters`` calls queued behind a device-side
    sleep, so they run back to back however slowly the host enqueues them,
    timed with CUDA events. A call whose launches overflow the launch queue
    is timed with the gaps the host leaves."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)      # ~50 ms of device time
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn: Callable[[], object], iters: int) -> float:
    """Host time of one call, enqueue to completion (what a caller waits)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters
