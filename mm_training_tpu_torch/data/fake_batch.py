"""Random fixed-shape request batches with plausible geometry (numpy only).

The port's copy of ``mm_training_tpu/data/fake_batch.py::make_fake_batch``
for the lidar slice: the same seeds give the same arrays as the JAX
package's function, key for key. Camera keys arrive with the camera slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..configs import Config

__all__ = ['make_fake_batch']


def make_fake_batch(cfg: Config, batch_size: Optional[int] = None,
                    seed: int = 0, n_objects: int = 24,
                    points_fill: float = 1.0) -> Dict[str, np.ndarray]:
    """Build a collated batch dict like the host loader produces.

    Keys: points [B,P,F] float32, point_mask [B,P] bool, gt_boxes [B,K,9],
    gt_labels [B,K] int32, gt_mask [B,K] bool, bda_mat [B,4,4], cam_ts [B].
    """
    if cfg.use_cam:
        raise NotImplementedError(
            'camera batches arrive with the camera slice (slice 3)')
    rng = np.random.default_rng(seed)
    b = batch_size or cfg.batch_size
    pc = cfg.point_cloud_range
    n_feat = cfg.lidar_input_channels

    p_cap = cfg.max_points
    n_pts = max(1, int(p_cap * points_fill))
    pts = np.zeros((b, p_cap, n_feat), np.float32)
    pts[:, :n_pts, 0] = rng.uniform(pc[0], pc[3], (b, n_pts))
    pts[:, :n_pts, 1] = rng.uniform(pc[1], pc[4], (b, n_pts))
    pts[:, :n_pts, 2] = rng.uniform(pc[2], pc[5], (b, n_pts))
    pts[:, :n_pts, 3] = rng.uniform(0, 1, (b, n_pts))       # intensity/is_radar
    if n_feat == 8:
        pts[:, :n_pts, 4] = rng.uniform(-10, 10, (b, n_pts))  # speed
        pts[:, :n_pts, 5] = rng.uniform(0, 40, (b, n_pts))    # power
        pts[:, :n_pts, 6] = rng.uniform(0, 1, (b, n_pts))     # intensity
        pts[:, :n_pts, 7] = rng.uniform(0, 0.1, (b, n_pts))   # ts
    else:
        pts[:, :n_pts, 4] = rng.uniform(0, 0.1, (b, n_pts))
    mask = np.zeros((b, p_cap), bool)
    mask[:, :n_pts] = True

    k_cap = cfg.max_objs
    k = min(n_objects, k_cap)
    gt_boxes = np.zeros((b, k_cap, 9), np.float32)
    gt_boxes[:, :k, 0] = rng.uniform(pc[0] * 0.9, pc[3] * 0.9, (b, k))
    gt_boxes[:, :k, 1] = rng.uniform(pc[1] * 0.9, pc[4] * 0.9, (b, k))
    gt_boxes[:, :k, 2] = rng.uniform(-1.0, 1.0, (b, k))
    gt_boxes[:, :k, 3:6] = rng.uniform(0.6, 8.0, (b, k, 3))
    gt_boxes[:, :k, 6] = rng.uniform(-np.pi, np.pi, (b, k))
    gt_boxes[:, :k, 7:9] = rng.normal(0, 4, (b, k, 2))
    gt_labels = np.zeros((b, k_cap), np.int32)
    gt_labels[:, :k] = rng.integers(0, 4, (b, k))
    gt_mask = np.zeros((b, k_cap), bool)
    gt_mask[:, :k] = True

    return {
        'points': pts, 'point_mask': mask,
        'gt_boxes': gt_boxes, 'gt_labels': gt_labels, 'gt_mask': gt_mask,
        'bda_mat': np.broadcast_to(np.eye(4, dtype=np.float32),
                                   (b, 4, 4)).copy(),
        'cam_ts': np.full((b,), 0.05, np.float32),
    }
