"""Random fixed-shape request batches with plausible geometry (numpy only).

The port's copy of ``mm_training_tpu/data/fake_batch.py::make_fake_batch``:
the same seeds give the same arrays as the JAX package's function, key for
key (the random draws in the same order), camera rig included.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..configs import BDAAugConf, Config

__all__ = ['make_fake_batch', 'random_bda_matrices']


def _camera_rigs(num_cameras: int):
    """Body->sensor extrinsics for a plausible rig: cameras looking forward /
    backward / sideways (body x fwd, y left, z up; optical z fwd, x right,
    y down). Zero roll and pitch, as the factorized splat needs."""
    yaws = np.linspace(0, 2 * np.pi, num_cameras, endpoint=False)
    rigs = []
    body_to_optical = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float64)
    for yaw in yaws:
        c, s = np.cos(yaw), np.sin(yaw)
        rot_body = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        rt = np.eye(4)
        rt[:3, :3] = body_to_optical @ rot_body.T
        rt[:3, 3] = [0.0, 0.1, -1.5]
        rigs.append(rt)
    return rigs


def make_fake_batch(cfg: Config, batch_size: Optional[int] = None,
                    seed: int = 0, n_objects: int = 24,
                    points_fill: float = 1.0, pitch_deg: float = 0.0) -> Dict[str, np.ndarray]:
    """Build a collated batch dict like the host loader produces.

    Keys: imgs uint8 [B,S,N,H,W,3], cam_ts [B], sensor2ego/intrin/extrinsics
    [B,S,N,4,4], points [B,P,F] float32, point_mask [B,P] bool, bda_mat
    [B,4,4] (the identity), gt_boxes [B,K,9], gt_labels [B,K] int32, gt_mask
    [B,K] bool. Without the camera, imgs and the matrices are 1-camera
    placeholders.

    ``pitch_deg`` pitches every camera of the rig by that angle about its
    optical x axis (``sensor2ego @ R_x``, the extrinsics its inverse), as
    ``tests/test_training/test_trainer_e2e.py`` does: a raw rig, whose BEV
    cell of a frustum point depends on its image row, so the general splat
    (``configs.raw_rig``) is the exact one. 0 keeps the JAX package's rig.
    """
    rng = np.random.default_rng(seed)
    b = batch_size or cfg.batch_size
    s, n = cfg.num_sweeps, cfg.num_cameras
    h, w = cfg.final_dim
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

    sample = {
        'points': pts, 'point_mask': mask,
        'gt_boxes': gt_boxes, 'gt_labels': gt_labels, 'gt_mask': gt_mask,
        'bda_mat': np.broadcast_to(np.eye(4, dtype=np.float32),
                                   (b, 4, 4)).copy(),
        'cam_ts': np.full((b,), 0.05, np.float32),
    }
    if cfg.use_cam:
        imgs = rng.integers(0, 255, (b, s, n, h, w, 3), dtype=np.uint8)
        rigs = _camera_rigs(n)
        extr = np.stack(rigs).astype(np.float32)                 # [N, 4, 4]
        s2e = np.stack([np.linalg.inv(r) for r in rigs]).astype(np.float32)
        f = 0.9 * w
        intr = np.eye(4, dtype=np.float32)
        intr[0, 0], intr[1, 1] = f, f
        intr[0, 2], intr[1, 2] = w / 2, h / 2
        sample['imgs'] = imgs
        sample['extrinsics'] = np.broadcast_to(extr, (b, s, n, 4, 4)).copy()
        sample['sensor2ego'] = np.broadcast_to(s2e, (b, s, n, 4, 4)).copy()
        sample['intrin'] = np.broadcast_to(intr, (b, s, n, 4, 4)).copy()
        if pitch_deg:
            a = np.deg2rad(pitch_deg)
            pitch = np.eye(4)
            pitch[1:3, 1:3] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
            sample['sensor2ego'] = (sample['sensor2ego'] @ pitch).astype(np.float32)
            sample['extrinsics'] = np.linalg.inv(sample['sensor2ego']).astype(np.float32)
    else:
        sample['imgs'] = np.zeros((b, 1, 1, 1, 1, 3), np.uint8)
        eye = np.broadcast_to(np.eye(4, dtype=np.float32), (b, 1, 1, 4, 4))
        sample['sensor2ego'] = eye.copy()
        sample['intrin'] = eye.copy()
        sample['extrinsics'] = eye.copy()
    return sample


def random_bda_matrices(batch_size: int, seed: int) -> np.ndarray:
    """[B, 4, 4] float32 BEV augmentations drawn as the training loader
    draws them (``mm_training_tpu/core/transforms.py::sample_bda`` and
    ``bda_transform``) from the default ``BDAAugConf``: a yaw in
    ``rot_lim`` degrees, a scale in ``scale_lim`` and the x / y flips,
    ``flip @ (scale @ rot)`` in the xyz block. The fake batch's own
    ``bda_mat`` is the identity; this is the non-trivial one."""
    conf = BDAAugConf()
    rng = np.random.default_rng(seed)
    out = np.broadcast_to(np.eye(4, dtype=np.float32), (batch_size, 4, 4)).copy()
    for i in range(batch_size):
        ang = np.deg2rad(rng.uniform(*conf.rot_lim))
        scale = rng.uniform(*conf.scale_lim)
        flip = np.diag([-1.0 if rng.uniform() < conf.flip_dx_ratio else 1.0,
                        -1.0 if rng.uniform() < conf.flip_dy_ratio else 1.0, 1.0])
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        out[i, :3, :3] = flip @ (np.eye(3) * scale @ rot)
    return out
