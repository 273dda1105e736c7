"""Frozen copies of the port's batch generators and random draws.

Copies of ``data/fake_batch.py::make_fake_batch`` (its camera rig, boxes
and images), ``exps/kernel_inputs.py::lidar_like_points`` and
``random_bda_matrices``, and the layout of
``training/train_step.py::draw_train_randoms``: the program may change, the
yardstick may not. ``tests/test_bench_traffic.py`` holds them to the port's
functions. ``cfg`` is the configuration object the harness runs (the port's
``Config`` built from the configuration file); only its fields are read.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _camera_rigs(num_cameras: int):
    """Body->sensor extrinsics: cameras looking forward / backward /
    sideways, zero roll and pitch (the virtualized rig)."""
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


def make_fake_batch(cfg, batch_size: int, seed: int, n_objects: int) -> Dict[str, np.ndarray]:
    """A collated batch as the host loader makes it: uniform points, boxes,
    labels, random uint8 images and the rig's matrices, the identity BDA."""
    rng = np.random.default_rng(seed)
    b = batch_size
    s, n = cfg.num_sweeps, cfg.num_cameras
    h, w = cfg.final_dim
    pc = cfg.point_cloud_range
    n_feat = cfg.lidar_input_channels

    p_cap = cfg.max_points
    n_pts = p_cap
    pts = np.zeros((b, p_cap, n_feat), np.float32)
    pts[:, :n_pts, 0] = rng.uniform(pc[0], pc[3], (b, n_pts))
    pts[:, :n_pts, 1] = rng.uniform(pc[1], pc[4], (b, n_pts))
    pts[:, :n_pts, 2] = rng.uniform(pc[2], pc[5], (b, n_pts))
    pts[:, :n_pts, 3] = rng.uniform(0, 1, (b, n_pts))
    if n_feat == 8:
        pts[:, :n_pts, 4] = rng.uniform(-10, 10, (b, n_pts))
        pts[:, :n_pts, 5] = rng.uniform(0, 40, (b, n_pts))
        pts[:, :n_pts, 6] = rng.uniform(0, 1, (b, n_pts))
        pts[:, :n_pts, 7] = rng.uniform(0, 0.1, (b, n_pts))
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
        'bda_mat': np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)).copy(),
        'cam_ts': np.full((b,), 0.05, np.float32),
    }
    if cfg.use_cam:
        imgs = rng.integers(0, 255, (b, s, n, h, w, 3), dtype=np.uint8)
        rigs = _camera_rigs(n)
        extr = np.stack(rigs).astype(np.float32)
        s2e = np.stack([np.linalg.inv(r) for r in rigs]).astype(np.float32)
        f = 0.9 * w
        intr = np.eye(4, dtype=np.float32)
        intr[0, 0], intr[1, 1] = f, f
        intr[0, 2], intr[1, 2] = w / 2, h / 2
        sample['imgs'] = imgs
        sample['extrinsics'] = np.broadcast_to(extr, (b, s, n, 4, 4)).copy()
        sample['sensor2ego'] = np.broadcast_to(s2e, (b, s, n, 4, 4)).copy()
        sample['intrin'] = np.broadcast_to(intr, (b, s, n, 4, 4)).copy()
    else:
        sample['imgs'] = np.zeros((b, 1, 1, 1, 1, 3), np.uint8)
        eye = np.broadcast_to(np.eye(4, dtype=np.float32), (b, 1, 1, 4, 4))
        sample['sensor2ego'] = eye.copy()
        sample['intrin'] = eye.copy()
        sample['extrinsics'] = eye.copy()
    return sample


def lidar_like_points(cfg, batch_size: int, seed: int, points: int):
    """(points [B, P, F] float32, mask [B, P] bool): half of each frame
    uniform over the range, 40% at a range r from 2 m to the x extent with
    density falling as 1/r^2, 10% a 1 m x 1 m wall at (12, 4) m, in mixed
    sensor order; the last 2% of the slots masked out."""
    rng = np.random.default_rng(seed)
    pc = cfg.point_cloud_range
    f = cfg.lidar_input_channels
    b, p = batch_size, points
    pts = np.zeros((b, p, f), np.float32)
    n_uni, n_near = p // 2, 2 * p // 5
    pts[:, :n_uni, 0] = rng.uniform(pc[0], pc[3], (b, n_uni))
    pts[:, :n_uni, 1] = rng.uniform(pc[1], pc[4], (b, n_uni))
    r = np.exp(rng.uniform(np.log(2.0), np.log(pc[3]), (b, n_near)))
    th = rng.uniform(-np.pi, np.pi, (b, n_near))
    near = slice(n_uni, n_uni + n_near)
    pts[:, near, 0] = r * np.cos(th)
    pts[:, near, 1] = np.clip(r * np.sin(th), pc[1], pc[4] - 1e-3)
    wall = slice(n_uni + n_near, p)
    pts[:, wall, 0] = rng.uniform(12.0, 13.0, (b, p - n_uni - n_near))
    pts[:, wall, 1] = rng.uniform(4.0, 5.0, (b, p - n_uni - n_near))
    pts[..., 2] = rng.uniform(pc[2], pc[5], (b, p))
    pts[..., 3:] = rng.uniform(0, 1, (b, p, f - 3))
    order = rng.permuted(np.tile(np.arange(p), (b, 1)), axis=1)
    pts = np.take_along_axis(pts, order[..., None], 1)
    mask = np.ones((b, p), bool)
    mask[:, p - p // 50:] = False
    return pts, mask


def random_bda_matrices(cfg, batch_size: int, seed: int) -> np.ndarray:
    """[B, 4, 4] float32 BEV augmentations as the training loader draws
    them: a yaw in ``rot_lim`` degrees, a scale in ``scale_lim`` and the x /
    y flips, ``flip @ (scale @ rot)`` in the xyz block."""
    conf = cfg.bda_aug_conf
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


def draw_train_randoms(cfg, imgs_shape, generator: torch.Generator, device):
    """A camera train step's random draws for images [B, S, N, ...]:
    ``flipped`` [B*S*N] bool (each image flipped with probability 0.5) and
    ``dropout``, ASPP's keep masks, one [B*N, mid, fH, fW] bool a sweep in
    channels-last memory (each element kept with probability 0.5)."""
    b, s, n = imgs_shape[:3]
    bb = cfg.get_backbone_conf()
    mid, (fh, fw) = bb.depth_net_conf.mid_channels, bb.feat_hw
    flipped = torch.rand(b * s * n, generator=generator, device=device) < 0.5
    keep = [(torch.rand(b * n, fh, fw, mid, generator=generator, device=device) < 0.5
             ).permute(0, 3, 1, 2) for _ in range(s)]
    return {'flipped': flipped, 'dropout': keep}
