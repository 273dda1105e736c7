"""Plain PyTorch versions of ``depth_labels``: a frozen copy of the port's plain
functions, with each public name bound to its plain version."""
from __future__ import annotations
from typing import Sequence, Tuple
import torch
import torch.nn.functional as F
from .gaussian import true_div


EMPTY = 1e5


def depth_grid_to_onehot_plain(grid: torch.Tensor, d_bound: Sequence[float],
                               num_bins: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`depth_grid_to_onehot`."""
    d0, _, step = d_bound
    idx = true_div(grid.float() - (d0 - step), step)
    idx = torch.where((idx < num_bins) & (idx >= 0.0), idx, 0.0)
    return F.one_hot(idx.to(torch.int64), num_bins).to(torch.float32)


def _projection(points: torch.Tensor, extrinsics: torch.Tensor,
                intrinsics: torch.Tensor):
    """(depth, u, v) [B, N, P] float32 in the kernel's order of operations."""
    x, y, z = (points[:, None, :, i] for i in range(3))           # [B, 1, P]

    def row(m, r, a, b, c, d):
        e = [m[:, :, r, j, None] for j in range(4)]               # [B, N, 1]
        return ((a * e[0] + b * e[1]) + c * e[2]) + d * e[3]

    one = torch.ones((), dtype=torch.float32, device=points.device)
    cam = [row(extrinsics, r, x, y, z, one) for r in range(4)]
    p0, p1, p2 = (row(intrinsics, r, *cam) for r in range(3))
    den = torch.where(p2 == 0, torch.full_like(p2, 1e-9), p2)
    return cam[2], p0 / den, p1 / den


def min_depth_grid_plain(points: torch.Tensor, mask: torch.Tensor,
                         extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                         img_hw: Tuple[int, int], downsample: int) -> torch.Tensor:
    """[B*N, fH*fW] float32: the minimum depth of the kept points in each
    cell, 1e5 where none (the plain version of the kernel's projection
    phase)."""
    b, p, _ = points.shape
    n = extrinsics.shape[1]
    h, w = img_hw
    fh, fw = h // downsample, w // downsample
    depth, u, v = _projection(points.float(), extrinsics.float(), intrinsics.float())
    valid = (mask[:, None, :] & (depth > 1.0) & (u > 1) & (u < w - 1)
             & (v > 1) & (v < h - 1))
    seg = (v.to(torch.int32) // downsample) * fw + u.to(torch.int32) // downsample
    seg = torch.where(valid & (seg < fh * fw), seg, fh * fw).to(torch.int64)
    grid = torch.full((b * n, fh * fw + 1), EMPTY, dtype=torch.float32,
                      device=points.device)
    vals = torch.where(valid, depth, EMPTY).reshape(b * n, p)
    grid.scatter_reduce_(1, seg.reshape(b * n, p), vals, 'amin')
    return grid[:, :fh * fw]


def depth_labels_plain(points: torch.Tensor, mask: torch.Tensor,
                       extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                       img_hw: Tuple[int, int], downsample: int,
                       d_bound: Sequence[float], num_bins: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`depth_labels`."""
    h, w = img_hw
    grid = min_depth_grid_plain(points, mask, extrinsics, intrinsics, img_hw, downsample)
    labels = depth_grid_to_onehot_plain(grid, d_bound, num_bins)
    return labels.reshape(grid.shape[0], h // downsample, w // downsample, num_bins)


depth_labels = depth_labels_plain
depth_grid_to_onehot = depth_grid_to_onehot_plain
