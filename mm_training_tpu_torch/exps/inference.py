"""Inference entry point (the port of ``mm_training_tpu/exps/inference.py``).

Export mode (the JAX main, :40-57): load a checkpoint (``ckpt_path``), run
predict over the val split and write one aiMotive-format JSON a frame
under ``<out_path>/outputs`` (no metrics):

    python -m mm_training_tpu_torch.exps.inference --config lidar_radar \\
        --data-root /data/aimotive_dataset [--fold-bn] [--max-batches N] \\
        ckpt_path=output/lidar_radar/saved_models/best [key=value ...]

``--latency`` instead times the serving path on fake request batches
(``make_fake_batch``): repeated predict calls (forward + decode + NMS), each
ending in a host fetch of its outputs, reported as p50/p90/p99 ms:

    python -m mm_training_tpu_torch.exps.inference --latency [--config lidar_radar]
        [--batch-size 1] [--iters 50] [--fold-bn] [--device cuda] [key=value ...]

``--fold-bn`` folds each conv+BN pair for inference first
(``models/bn_fold.py``), in either mode. ``--config`` is any variant:
``lidar_only``, ``lidar_radar``, ``lidar_cam``, ``lidar_cam_radar``,
``eval_lidar_only``, ``eval_lidar_radar`` or ``tiny_test_config`` (camera
off; ``use_cam=True`` as an override turns it on). ``use_tta=True`` serves
the flip ensemble, ``use_ema=True`` (export) the checkpoint's EMA weights.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..data import make_fake_batch
from ..models import BEVDepthLiDAR
from ..models.bn_fold import fold_model
from ..training import make_predict_step
from ..training.trainer import Trainer
from .common import build_config, make_parser

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


def main(argv: Optional[Sequence[str]] = None):
    p = make_parser('Run inference + JSON export, or time the serving path',
                    extra_flags=('latency', 'fold-bn'))
    p.add_argument('--batch-size', type=int, default=1, help='--latency: the request batch')
    p.add_argument('--iters', type=int, default=50, help='--latency: timed calls')
    args = p.parse_args(argv)
    cfg = build_config(args)
    if args.latency:
        seed = cfg.seed if args.seed is None else args.seed
        model = BEVDepthLiDAR(cfg, device=args.device,
                              generator=torch.Generator().manual_seed(seed))
        if args.fold_bn:
            fold_model(model)
        step = make_predict_step(cfg, model)
        batch = make_fake_batch(cfg, batch_size=args.batch_size, seed=seed)
        stats = benchmark_latency(step, batch, args.iters)
        print('predict latency (fwd+decode+NMS+fetch): '
              + '  '.join(f'{k}={v:.3f}' if isinstance(v, float) else f'{k}={v}'
                          for k, v in stats.items()))
        return stats
    trainer = Trainer(cfg, device=args.device)
    try:
        trainer.setup(steps_per_epoch=1)
        trainer.init_state(next(iter(trainer.loader('val'))))   # restores cfg.ckpt_path
        if args.fold_bn:
            trainer.fold_bn_for_inference()
        trainer.predict(split='val', max_batches=args.max_batches)
    finally:
        trainer.close()
    out = str(trainer.out_path / 'outputs')
    print(f'results written under {out}')
    return out


if __name__ == '__main__':
    main()
