"""A profiled slice of a run: the device operations, the host operations
beside them, the union of the device's busy intervals and the idle gaps.

A profiler session that records no device operation is no measurement
(sessions have come back empty in processes that launched many kernels): it
is made again, up to three times, and then raises.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch

Interval = Tuple[str, float, float]     # (name, start s, end s)


def profile_slice(run: Callable[[], None], sessions: int = 3) -> Dict:
    """Profile ``run()`` (which ends in a host wait for its last result):
    {'device': [(name, start, end)], 'host': [...], 'window_s': host-clock
    length of the slice}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        device, host = [], []
        for e in prof.events():
            iv = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            if e.device_type == DeviceType.CUDA:
                device.append(iv)
            elif e.device_type == DeviceType.CPU:
                host.append(iv)
        if device:
            return {'device': device, 'host': host, 'window_s': window}
    raise RuntimeError(f'torch.profiler recorded no device operation in {sessions} sessions')


def busy_intervals(device: List[Interval]) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, in order."""
    merged: List[List[float]] = []
    for _, s, e in sorted(device, key=lambda iv: iv[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(device: List[Interval]) -> float:
    return sum(e - s for s, e in busy_intervals(device))


def top_device_ops(device: List[Interval], n: int = 10) -> List[List]:
    """[[name, seconds]] of the device operations that took most time."""
    total: Dict[str, float] = {}
    for name, s, e in device:
        total[name] = total.get(name, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(device: List[Interval], host: List[Interval], n: int = 10) -> List[List]:
    """[[host operation, seconds]] of the longest gaps between busy
    intervals, each named by the innermost host operation running at the
    gap's start."""
    busy = busy_intervals(device)
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1]) for i in range(len(busy) - 1)),
                  reverse=True)[:n]
    out = []
    for length, start in gaps:
        running = [iv for iv in host if iv[1] <= start < iv[2]]
        name = min(running, key=lambda iv: iv[2] - iv[1])[0] if running else 'no host op'
        out.append([name, length])
    return out
