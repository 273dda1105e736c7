"""The one traffic generator: a pool of distinct host batches from a
traffic file's parameters and the seed.

Parameters (``benchmark/traffic/<mix>.json``): ``loop`` (``train`` or
``predict``), ``batch_size``, ``pool`` (batches held in host memory and
cycled), ``points_per_frame`` (LiDAR-like frames), ``boxes_per_frame``
([lo, hi]: every seed gets the same set of counts, evenly spread over the
range, in another order), ``bda`` (``random``: the training loader's BEV
augmentation; ``identity``), and the loop's own counts (``checked_steps``,
``warmup_calls``, ``checked_calls``, ``profiled_steps``).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from . import frozen


def box_counts(traffic: Dict[str, Any], seed: int) -> np.ndarray:
    """[pool, B] boxes of each frame: the same sizes for every seed,
    permuted by the seed."""
    lo, hi = traffic['boxes_per_frame']
    n = traffic['pool'] * traffic['batch_size']
    counts = np.round(np.linspace(lo, hi, n)).astype(np.int64)
    return np.random.default_rng([seed, 1]).permutation(counts).reshape(traffic['pool'], -1)


def make_pool(cfg, traffic: Dict[str, Any], seed: int) -> List[Dict[str, np.ndarray]]:
    """``traffic['pool']`` batches of numpy arrays, each made from seeds
    drawn from ``seed``."""
    b, pool = traffic['batch_size'], traffic['pool']
    if cfg.batch_size != b:
        raise ValueError(f'the configuration trains at batch {cfg.batch_size}, the traffic '
                         f'sends {b}')
    if traffic['points_per_frame'] != cfg.max_points:
        raise ValueError(f'{traffic["points_per_frame"]} points a frame, the configuration '
                         f'holds {cfg.max_points}')
    seeds = np.random.default_rng([seed, 0]).integers(0, 2 ** 63, size=(pool, 3))
    counts = box_counts(traffic, seed)
    k_max = int(counts.max())
    out = []
    for i in range(pool):
        batch = frozen.make_fake_batch(cfg, b, int(seeds[i, 0]), k_max)
        pts, mask = frozen.lidar_like_points(cfg, b, int(seeds[i, 1]), traffic['points_per_frame'])
        batch['points'], batch['point_mask'] = pts, mask
        keep = np.arange(batch['gt_mask'].shape[1])[None, :] < counts[i][:, None]
        batch['gt_mask'] &= keep
        batch['gt_boxes'][~keep] = 0.0
        batch['gt_labels'][~keep] = 0
        if traffic['bda'] == 'random':
            batch['bda_mat'] = frozen.random_bda_matrices(cfg, b, int(seeds[i, 2]))
        elif traffic['bda'] != 'identity':
            raise ValueError(f'bda {traffic["bda"]!r}: random or identity')
        del batch['cam_ts']
        out.append(batch)
    return out
