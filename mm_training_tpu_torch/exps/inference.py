"""Serving latency of the port (``--latency``), on fake request batches.

The port of ``mm_training_tpu/exps/inference.py --latency`` (:18-37):
repeated predict calls (forward + decode + NMS), each ending in a host
fetch of its outputs, reported as p50/p90/p99 in milliseconds. Requests come
from ``make_fake_batch`` until the loaders are ported; the trainer,
checkpoints and JSON export arrive with the runtime slice (slice 5).

    python -m mm_training_tpu_torch.exps.inference --latency [--config lidar_radar]
        [--batch-size 1] [--iters 50] [--device cuda] [key=value ...]

``--config`` is any variant: ``lidar_only``, ``lidar_radar``, ``lidar_cam``,
``lidar_cam_radar`` or ``tiny_test_config`` (camera off; ``use_cam=True``
as an override turns it on).
"""
from __future__ import annotations

import argparse
import ast
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..configs import variants
from ..data import make_fake_batch
from ..models import BEVDepthLiDAR
from ..training import make_predict_step

__all__ = ['benchmark_latency', 'main']


def benchmark_latency(predict_step: Callable, batch: Dict[str, Any],
                      iters: int = 50) -> dict:
    """End-to-end predict latency (host batch in, forward + decode + NMS,
    outputs fetched to the host), after one warm-up call."""
    def call():
        return [o.cpu() for o in predict_step(batch)]  # the fetch synchronises

    call()
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.asarray(lat)
    return {'p50_ms': float(np.percentile(lat, 50)),
            'p90_ms': float(np.percentile(lat, 90)),
            'p99_ms': float(np.percentile(lat, 99)),
            'samples': iters, 'batch_size': int(batch['bda_mat'].shape[0])}


def _parse_value(v: str):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description='Serving latency of the port')
    p.add_argument('--latency', action='store_true',
                   help='benchmark predict latency (the only mode of this slice)')
    p.add_argument('--config', default='lidar_radar',
                   choices=('lidar_only', 'lidar_radar', 'lidar_cam', 'lidar_cam_radar',
                            'tiny_test_config'))
    p.add_argument('--batch-size', type=int, default=1)
    p.add_argument('--iters', type=int, default=50)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default=None, help='default cuda')
    p.add_argument('overrides', nargs='*', help='config overrides key=value')
    args = p.parse_args(argv)
    if not args.latency:
        raise SystemExit('only --latency is ported; prediction export arrives '
                         'with the trainer (slice 5)')
    kw = {}
    for ov in args.overrides:
        if '=' not in ov:
            raise SystemExit(f'override must be key=value, got {ov!r}')
        k, v = ov.split('=', 1)
        kw[k] = _parse_value(v)
    cfg = getattr(variants, args.config)(seed=args.seed, **kw)
    model = BEVDepthLiDAR(cfg, device=args.device,
                          generator=torch.Generator().manual_seed(args.seed))
    step = make_predict_step(cfg, model)
    batch = make_fake_batch(cfg, batch_size=args.batch_size, seed=args.seed)
    stats = benchmark_latency(step, batch, args.iters)
    print('predict latency (fwd+decode+NMS+fetch): '
          + '  '.join(f'{k}={v:.3f}' if isinstance(v, float) else f'{k}={v}'
                      for k, v in stats.items()))
    return stats


if __name__ == '__main__':
    main()
