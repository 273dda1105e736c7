"""Lightweight 3D box utilities (numpy).

The port's copy of ``mm_training_tpu/core/boxes.py``, its arithmetic
unchanged. Replaces the reference's dependency on mmdet3d's ``LiDARInstance3DBoxes``
(used at dataset/src/aimotive_dataset.py:9,229 and exps/mm_training_aim.py:19,390).

Conventions (matching the reference's aiMotive path):
  * a box is ``[x, y, z, dx, dy, dz, yaw, vx, vy]`` with ``z`` the *gravity
    center* (the aiMotive "Origin Z" is the box center; the reference converts
    to bottom-center only when it needs mmdet3d corners, mm_training_aim.py:389).
  * yaw rotates around +z, measured from +x toward +y.
"""
from __future__ import annotations

import numpy as np

__all__ = ['corners_3d', 'corners_bev', 'boxes_to_aabb_bev', 'points_in_boxes_mask']


def corners_3d(boxes: np.ndarray, origin=(0.5, 0.5, 0.5)) -> np.ndarray:
    """8 corners of [N, 7+] boxes (x, y, z, dx, dy, dz, yaw).

    ``origin`` is the position of (x, y, z) inside the box in unit coords;
    (0.5, 0.5, 0.5) = gravity center (aiMotive convention),
    (0.5, 0.5, 0.0) = bottom center (mmdet3d LiDARInstance3DBoxes convention).

    Returns [N, 8, 3]; corner order: z-minor, y-mid, x-major binary count
    (corner k = (x_sign, y_sign, z_sign) of bit pattern), matching a simple
    unit-cube enumeration (not mmdet3d's specific order — only used for viz).
    """
    boxes = np.asarray(boxes)
    n = boxes.shape[0]
    dims = boxes[:, 3:6]
    # unit cube corners in {0,1}^3 minus origin
    unit = np.array([[(i >> 2) & 1, (i >> 1) & 1, i & 1] for i in range(8)],
                    dtype=boxes.dtype if boxes.dtype.kind == 'f' else np.float32)
    offs = (unit[None, :, :] - np.asarray(origin)[None, None, :]) * dims[:, None, :]
    yaw = boxes[:, 6]
    c, s = np.cos(yaw), np.sin(yaw)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    rot = np.stack([
        np.stack([c, -s, zeros], -1),
        np.stack([s, c, zeros], -1),
        np.stack([zeros, zeros, ones], -1),
    ], -2)  # [N, 3, 3]
    rotated = np.einsum('nij,nkj->nki', rot, offs)
    return rotated + boxes[:, None, 0:3]


def corners_bev(boxes: np.ndarray) -> np.ndarray:
    """4 BEV corners of [N, 7+] boxes -> [N, 4, 2] (x, y)."""
    boxes = np.asarray(boxes)
    half = boxes[:, 3:5] / 2.0
    unit = np.array([[-1, -1], [-1, 1], [1, 1], [1, -1]], dtype=np.float32)
    offs = unit[None, :, :] * half[:, None, :]
    yaw = boxes[:, 6]
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    return np.einsum('nij,nkj->nki', rot, offs) + boxes[:, None, 0:2]


def boxes_to_aabb_bev(boxes: np.ndarray) -> np.ndarray:
    """Axis-aligned BEV boxes [x1, y1, x2, y2] the way the reference evaluator
    builds them (utils/eval.py:626-663: yaw IGNORED, box = center +- extent/2)."""
    boxes = np.asarray(boxes)
    x, y = boxes[:, 0], boxes[:, 1]
    l, w = boxes[:, 3], boxes[:, 4]
    return np.stack([x - l / 2, y - w / 2, x + l / 2, y + w / 2], -1)


def points_in_boxes_mask(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Axis-aligned containment test used by the reference's >5-point
    annotation filter (dataset/src/data_loader.py:129-150 — note it ignores
    yaw, testing the AABB). points [P, 3+], boxes [N, 6+] -> bool [N, P].

    Formulated as per-axis [N, P] compares in the points' own float dtype:
    the naive [N, P, 3] float64 broadcast costs ~27 ms/sample at 100k
    points on the loader hot path; this is ~5x cheaper."""
    p = np.ascontiguousarray(np.asarray(points)[:, :3])
    dt = p.dtype if np.issubdtype(p.dtype, np.floating) else np.float64
    b = np.asarray(boxes, dt)
    lo = b[:, 0:3] - b[:, 3:6] / 2              # [N, 3]
    hi = b[:, 0:3] + b[:, 3:6] / 2
    mask = ((p[None, :, 0] >= lo[:, None, 0])
            & (p[None, :, 0] <= hi[:, None, 0]))
    for ax in (1, 2):
        mask &= p[None, :, ax] >= lo[:, None, ax]
        mask &= p[None, :, ax] <= hi[:, None, ax]
    return mask
