"""Timing helpers for the card (CUDA events and the host clock), and the
card's published peak rates that every bound of this package is taken
against."""
from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ['BF16_FLOPS', 'FP32_FLOPS', 'HBM_BYTES_PER_S', 'device_ms', 'device_ops',
           'host_ms']

# NVIDIA H100 SXM, data sheet, dense, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12   # device memory
FP32_FLOPS = 67e12          # fp32 outside the tensor cores
BF16_FLOPS = 989e12         # bf16 on the tensor cores


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


def device_ops(fn: Callable[[], object], sessions: int = 3) -> dict:
    """{name: count} of the device operations (kernels, copies, fills) of
    one call, after a warm-up call, as torch.profiler records them.

    A profiler session that records no device operation at all is no
    measurement (a session in a process has come back without device
    events): the call is profiled again, up to ``sessions`` sessions, and
    RuntimeError is raised when every one came back empty."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = {e.key: e.count for e in prof.key_averages() if e.device_type.name == 'CUDA'}
        if ops:
            return ops
    raise RuntimeError(f'torch.profiler recorded no device operation in {sessions} sessions')
