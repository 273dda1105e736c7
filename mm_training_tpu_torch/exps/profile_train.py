"""Where a training step's time goes on the card (torch.profiler).

Builds the full-width ``lidar_radar`` model (grid 256 x 2048, 100k 8-feature
points a frame, bf16 compute over float32 masters) with seeded random
weights, runs ``--warmup`` train steps on one fixed fake batch, then
profiles ``--steps`` steps and prints: host wall time per step, device time
per step summed over kernels, the device's busy share (device time / wall
time), device ops per step, peak device memory, and the kernels and host
ops that take the most time. Before the profiled window it times
``--steps`` unprofiled steps (host clock, each ending in a synchronize).

    python -m mm_training_tpu_torch.exps.profile_train [--batch-size 4]
        [--steps 10] [--warmup 3] [--trace train_trace.json]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import lidar_radar
from ..data import make_fake_batch
from ..models import BEVDepthLiDAR
from ..training import TrainState, create_train_state, make_train_step

__all__ = ['benchmark_train', 'main']


def benchmark_train(train_step: Callable, state: TrainState, batch: Dict[str, Any],
                    steps: int) -> dict:
    """Step time on the host clock (batch in host memory to the updated
    state and metrics on the card, each step ending in a synchronize),
    samples/s at the p50, and the peak device memory over the steps."""
    torch.cuda.reset_peak_memory_stats()
    lat, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics['train_loss']))
    lat = np.asarray(lat)
    b = int(batch['points'].shape[0])
    p50 = float(np.percentile(lat, 50))
    return {'p50_ms': p50, 'p90_ms': float(np.percentile(lat, 90)),
            'samples_per_s': b / p50 * 1e3, 'steps': steps, 'batch_size': b,
            'max_memory_allocated_gb': torch.cuda.max_memory_allocated() / 2**30,
            'losses': losses}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--batch-size', type=int, default=4)
    p.add_argument('--steps', type=int, default=10)
    p.add_argument('--warmup', type=int, default=3)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--trace', default=None, help='write a Chrome trace here')
    args = p.parse_args(argv)

    cfg = lidar_radar(batch_size=args.batch_size, max_points_per_frame=100_000)
    model = BEVDepthLiDAR(cfg, generator=torch.Generator().manual_seed(args.seed))
    state = create_train_state(cfg, model)
    train_step = make_train_step(cfg)
    batch = make_fake_batch(cfg, seed=args.seed)
    for _ in range(args.warmup):
        state, _ = train_step(state, batch)
    torch.cuda.synchronize()
    timed = benchmark_train(train_step, state, batch, args.steps)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)

    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type.name == 'CUDA' and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    top_dev = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    host = [e for e in events if e.device_type.name == 'CPU']
    top_host = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    result = {
        'device': torch.cuda.get_device_name(0), 'batch_size': args.batch_size,
        'steps': args.steps, 'unprofiled': timed,
        'wall_ms_per_step': wall_ms, 'device_ms_per_step': device_ms,
        'device_busy_share': device_ms / wall_ms,
        'device_ops_per_step': sum(e.count for e in kernels) / args.steps,
        'top_device_ms_per_step': [
            (e.key[:80], e.self_device_time_total / 1e3 / args.steps, e.count / args.steps)
            for e in top_dev],
        'top_host_self_ms_per_step': [
            (e.key[:80], e.self_cpu_time_total / 1e3 / args.steps, e.count / args.steps)
            for e in top_host],
    }
    print(json.dumps(result, indent=1))
    return result


if __name__ == '__main__':
    main()
