"""Rotation / BDA-augmentation math (host-side numpy).

The port's copy of ``mm_training_tpu/core/transforms.py``, its arithmetic
unchanged (the dataset's batches must equal the JAX package's byte for
byte). Covers the reference's quaternion->yaw conversion
(dataset/src/data_loader.py:250-254), BDA sampling/box transform
(dataset/src/aimotive_dataset.py:64-103), and the Z-forward camera frame
convention (data_loader.py:37-39).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    'rot_z', 'quat_to_yaw', 'yaw_to_quat', 'sample_bda', 'bda_transform',
    'R_Z_FORWARD_TO_BODY',
]

# optical (z-forward) camera frame -> body (x-forward) frame
# (reference dataset/src/data_loader.py:37-39)
R_Z_FORWARD_TO_BODY = np.array([[0, 0, 1],
                                [-1, 0, 0],
                                [0, -1, 0]], dtype=np.float64)


def rot_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def quat_to_yaw(qx, qy, qz, qw) -> float:
    """Yaw (z euler angle, xyz order) of a quaternion — matches
    scipy Rotation.from_quat(...).as_euler('xyz')[2] used at
    data_loader.py:250-254."""
    # standard ZYX-free extraction of the 'xyz' intrinsic euler z component:
    # scipy as_euler('xyz') returns extrinsic xyz; its third angle is
    # atan2(2(qw qz + qx qy), 1 - 2(qy^2 + qz^2))
    return float(np.arctan2(2.0 * (qw * qz + qx * qy),
                            1.0 - 2.0 * (qy * qy + qz * qz)))


def yaw_to_quat(yaw: float) -> np.ndarray:
    """Quaternion (x, y, z, w) for a pure z rotation — matches
    scipy Rotation.from_euler('z', yaw).as_quat() used at
    exps/mm_training_aim.py:235."""
    h = yaw / 2.0
    return np.array([0.0, 0.0, np.sin(h), np.cos(h)], dtype=np.float64)


def sample_bda(rng: np.random.Generator, conf, training: bool):
    """Sample BEV-aug params (aimotive_dataset.py:64-77)."""
    if training:
        rotate_bda = float(rng.uniform(*conf.rot_lim))
        scale_bda = float(rng.uniform(*conf.scale_lim))
        flip_dx = bool(rng.uniform() < conf.flip_dx_ratio)
        flip_dy = bool(rng.uniform() < conf.flip_dy_ratio)
    else:
        rotate_bda, scale_bda, flip_dx, flip_dy = 0.0, 1.0, False, False
    return rotate_bda, scale_bda, flip_dx, flip_dy


def bda_transform(gt_boxes: np.ndarray, rotate_angle_deg: float,
                  scale_ratio: float, flip_dx: bool, flip_dy: bool):
    """Apply BEV aug to [N, 9] boxes; returns (boxes, 3x3 transform).

    Matches aimotive_dataset.py:79-103: boxes rotate/scale/flip in xyz;
    yaw += angle, then mirrored per flip; velocity rotated by the 2x2 block.
    """
    ang = np.deg2rad(rotate_angle_deg)
    rot_mat = rot_z(ang)
    scale_mat = np.eye(3) * scale_ratio
    flip_mat = np.eye(3)
    if flip_dx:
        flip_mat = flip_mat @ np.diag([-1.0, 1.0, 1.0])
    if flip_dy:
        flip_mat = flip_mat @ np.diag([1.0, -1.0, 1.0])
    tr = flip_mat @ (scale_mat @ rot_mat)

    gt_boxes = np.array(gt_boxes, dtype=np.float32, copy=True)
    if gt_boxes.shape[0] > 0:
        gt_boxes[:, :3] = gt_boxes[:, :3] @ tr.T.astype(np.float32)
        gt_boxes[:, 3:6] *= scale_ratio
        gt_boxes[:, 6] += ang
        if flip_dx:
            gt_boxes[:, 6] = np.pi - gt_boxes[:, 6]
        if flip_dy:
            gt_boxes[:, 6] = -gt_boxes[:, 6]
        if gt_boxes.shape[1] >= 9:
            gt_boxes[:, 7:9] = gt_boxes[:, 7:9] @ tr[:2, :2].T.astype(np.float32)
    return gt_boxes, tr.astype(np.float32)
