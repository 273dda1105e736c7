"""Kernel K1: fixed-shape pillar voxelization + mean VFE.

The port of ``mm_training_tpu/ops/voxelize.py::voxelize_pillars_dense``:
floor-quantize points onto the (ny, nx) pillar grid and take the per-pillar
mean of their first ``num_features`` features (empty pillars are zero). The
CUDA source is ``csrc/voxelize.cu`` (atomic scatter of [feats, 1] rows, then
a normalize pass); it is bound by device-memory bytes, see the note there.

Points stay float32 whatever the model's compute type: bf16 cannot resolve
0.2 m voxels at 200 m range. Inputs are batched, ``points [B, P, F]``,
``mask [B, P]`` (the JAX function takes one sample and is vmapped).

The optional ``max_points_per_voxel`` cap (mmdet3d's first-K-points-in-input-
order subsampling) is not on the serving path. It is computed here in PyTorch
as a stable-sort rank, which narrows the mask before either version runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import build

__all__ = ['voxelize_pillars_dense', 'voxelize_pillars_dense_plain',
           'pillar_segments']


def _num_z_bins(pc_range: Sequence[float], voxel_size: Sequence[float]) -> int:
    z0, z1, vz = pc_range[2], pc_range[5], voxel_size[2]
    nz = 1 + int((z1 - z0) / vz - 1e-6)
    if nz != 1:
        raise ValueError(
            f'voxelize_pillars_dense is pillar-only: voxel z size {vz} gives '
            f'{nz} z bins over [{z0}, {z1}]; distinct z voxels would be '
            'averaged together. Use vz >= the z extent.')
    return nz


def pillar_segments(points: torch.Tensor, mask: torch.Tensor,
                    pc_range: Sequence[float], voxel_size: Sequence[float],
                    grid_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, P] int64 pillar index ``yi * nx + xi``, or ``ny * nx`` for a point
    that is masked out or outside the range."""
    ny, nx = grid_hw
    nz = _num_z_bins(pc_range, voxel_size)

    def cell(axis: int) -> torch.Tensor:
        # the divisor is a tensor on the points' device: dividing a CUDA
        # tensor by a Python number multiplies by its reciprocal, which
        # rounds differently and moves points across cell borders
        v = torch.tensor(voxel_size[axis], dtype=torch.float32, device=points.device)
        return torch.floor((points[..., axis] - pc_range[axis]) / v)

    xi, yi, zi = cell(0), cell(1), cell(2)
    valid = (mask & (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
             & (zi >= 0) & (zi < nz))
    seg = yi.long() * nx + xi.long()
    return torch.where(valid, seg, torch.full_like(seg, ny * nx))


def _first_k_mask(points, mask, pc_range, voxel_size, grid_hw, cap: int):
    """``mask`` narrowed to the first ``cap`` points of each pillar in input
    order: rank within the pillar = position in a stable sort by pillar
    minus the first position of that pillar's run."""
    seg = pillar_segments(points, mask, pc_range, voxel_size, grid_hw)
    seg_sorted, order = torch.sort(seg, dim=1, stable=True)
    pos = torch.arange(seg.shape[1], device=seg.device).expand_as(seg)
    rank_sorted = pos - torch.searchsorted(seg_sorted, seg_sorted, side='left')
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    return mask & (rank < cap)


def voxelize_pillars_dense_plain(points: torch.Tensor, mask: torch.Tensor,
                                 pc_range: Sequence[float],
                                 voxel_size: Sequence[float],
                                 grid_hw: Tuple[int, int],
                                 num_features: int = 5) -> torch.Tensor:
    """Plain PyTorch version: one ``index_add_`` of [feats * w, w] rows into
    G + 1 segments per sample (segment G collects the invalid points)."""
    b, p, _ = points.shape
    ny, nx = grid_hw
    g = ny * nx
    seg = pillar_segments(points, mask, pc_range, voxel_size, grid_hw)
    w = (seg < g).to(points.dtype)[..., None]
    rows = torch.cat([points[..., :num_features] * w, w], dim=-1)
    flat = (seg + torch.arange(b, device=seg.device)[:, None] * (g + 1)).reshape(-1)
    agg = torch.zeros(b * (g + 1), num_features + 1, dtype=points.dtype,
                      device=points.device)
    agg.index_add_(0, flat, rows.reshape(-1, num_features + 1))
    agg = agg.view(b, g + 1, num_features + 1)[:, :g]
    mean = agg[..., :num_features] / agg[..., num_features:].clamp_min(1.0)
    return mean.reshape(b, ny, nx, num_features)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load('voxelize')
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.pillar_scatter_mean.argtypes = [p, p, i64, i64, i32, i32, f32, f32, f32,
                                        f32, f32, f32, i32, i32, i32, p, p, p]
    lib.pillar_scatter_mean.restype = ctypes.c_int
    return lib


def voxelize_pillars_dense(points: torch.Tensor, mask: torch.Tensor,
                           pc_range: Sequence[float], voxel_size: Sequence[float],
                           grid_hw: Tuple[int, int], num_features: int = 5,
                           max_points_per_voxel: Optional[int] = None
                           ) -> torch.Tensor:
    """Mean-pool padded points into a dense pillar grid.

    Args:
      points: [B, P, F] float32 (F >= num_features; x, y, z first).
      mask: [B, P] bool validity of each point.
      pc_range: (x0, y0, z0, x1, y1, z1); voxel_size: (vx, vy, vz).
      grid_hw: (ny, nx) pillar grid.
      num_features: how many leading features are averaged.
      max_points_per_voxel: average only the first K points (input order) of
        each pillar, as mmdet3d's hard voxelizer does.

    Returns [B, ny, nx, num_features] float32. CPU tensors take
    :func:`voxelize_pillars_dense_plain`; CUDA tensors launch the kernel.
    """
    if points.dim() != 3 or mask.shape != points.shape[:2] or mask.dtype != torch.bool:
        raise ValueError(f'voxelize_pillars_dense: points [B, P, F] and bool mask '
                         f'[B, P], got {tuple(points.shape)} and '
                         f'{tuple(mask.shape)} {mask.dtype}')
    if points.dtype != torch.float32 or not 3 <= num_features <= points.shape[2]:
        raise ValueError('voxelize_pillars_dense: points must be float32 with '
                         f'at least max(3, num_features={num_features}) features')
    if max_points_per_voxel is not None:
        mask = _first_k_mask(points, mask, pc_range, voxel_size, grid_hw,
                             max_points_per_voxel)
    if points.device.type == 'cpu':
        return voxelize_pillars_dense_plain(points, mask, pc_range, voxel_size,
                                            grid_hw, num_features)
    if points.device.type != 'cuda' or mask.device != points.device:
        raise ValueError(f'voxelize_pillars_dense: points on {points.device}, '
                         f'mask on {mask.device}')
    nz = _num_z_bins(pc_range, voxel_size)
    b, p, f = points.shape
    ny, nx = grid_hw
    points, mask = points.contiguous(), mask.contiguous()
    acc = torch.zeros(b, ny * nx, num_features + 1, dtype=torch.float32,
                      device=points.device)
    out = torch.empty(b, ny, nx, num_features, dtype=torch.float32,
                      device=points.device)
    lib = _lib()
    with torch.cuda.device(points.device):
        code = lib.pillar_scatter_mean(
            points.data_ptr(), mask.data_ptr(), b, p, f, num_features,
            pc_range[0], pc_range[1], pc_range[2], voxel_size[0], voxel_size[1],
            voxel_size[2], nx, ny, nz, acc.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(points.device).cuda_stream)
    build.check(lib, code, 'voxelize_pillars_dense')
    voxelize_pillars_dense.launches += 1
    return out


voxelize_pillars_dense.launches = 0
