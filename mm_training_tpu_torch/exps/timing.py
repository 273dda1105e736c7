"""Timing helpers for the card (CUDA events and the host clock), and the
card's published peak rates that every bound of this package is taken
against."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import torch

__all__ = ['BF16_FLOPS', 'FP32_FLOPS', 'HBM_BYTES_PER_S', 'device_ms', 'device_ops',
           'device_ops_in_child', 'host_ms']

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


# a call for device_ops_in_child: (module of the port, function, args, kwargs)
Call = Tuple[str, str, tuple, dict]

_CHILD = """
import importlib, json, sys, torch
from mm_training_tpu_torch.exps.timing import device_ops
sessions = torch.load(sys.argv[1], weights_only=False)
out = []
for calls in sessions:
    fns = [(getattr(importlib.import_module('mm_training_tpu_torch.' + m), f), a, k)
           for m, f, a, k in calls]
    out.append(device_ops(lambda: [fn(*a, **k) for fn, a, k in fns]))
print(json.dumps(out))
"""


def device_ops_in_child(sessions: Sequence[Sequence[Call]], timeout: float = 300.0
                        ) -> List[Dict[str, int]]:
    """:func:`device_ops` of each session, a list of calls ``(module,
    function, args, kwargs)`` (``module`` relative to the package, e.g.
    ``'ops.gaussian'``), counted in a fresh interpreter: torch.profiler
    sessions of a process that has launched many kernels have come back
    without device events, while the same count in a new process holds.
    The arguments (tensors on the card included) go to the child through a
    ``torch.save`` file. Raises with the child's output when it fails."""
    root = Path(__file__).resolve().parents[2]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, 'sessions.pt')
        torch.save([list(calls) for calls in sessions], path)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root)] + [p for p in os.environ.get('PYTHONPATH', '').split(os.pathsep) if p]))
        out = subprocess.run([sys.executable, '-c', _CHILD, path], cwd=root, env=env,
                             capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f'device_ops_in_child failed ({out.returncode}):\n'
                           f'{out.stdout[-4000:]}\n{out.stderr[-4000:]}')
    return json.loads(out.stdout.strip().splitlines()[-1])
