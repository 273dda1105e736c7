"""Plain PyTorch versions of ``voxelize``: a frozen copy of the port's plain
functions, with each public name bound to its plain version."""
from __future__ import annotations
from typing import Optional, Sequence, Tuple
import torch


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


def voxelize_pillars_dense_plain(points: torch.Tensor, mask: torch.Tensor,
                                 pc_range: Sequence[float],
                                 voxel_size: Sequence[float],
                                 grid_hw: Tuple[int, int],
                                 num_features: int = 5, return_count: bool = False):
    """Plain PyTorch version: one ``index_add_`` of [feats * w, w] rows into
    G + 1 segments per sample (segment G collects the invalid points).
    ``return_count``: also the [B, ny, nx, 1] points averaged a pillar."""
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
    mean = mean.reshape(b, ny, nx, num_features)
    if return_count:
        return mean, agg[..., num_features:].reshape(b, ny, nx, 1)
    return mean


def pillar_encoder_input_plain(points: torch.Tensor, mask: torch.Tensor,
                               pc_range: Sequence[float], voxel_size: Sequence[float],
                               grid_hw: Tuple[int, int], num_features: int = 5,
                               dtype: torch.dtype = torch.float32,
                               space_to_depth: bool = True,
                               channels: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: :func:`voxelize_pillars_dense_plain`, one cast
    to ``dtype``, the 2x2 space-to-depth (``models/resnet.py``), then zero
    channels up to ``channels``."""
    from ..models.resnet import space_to_depth_2x2   # models import this module
    x = voxelize_pillars_dense_plain(points, mask, pc_range, voxel_size, grid_hw,
                                     num_features).to(dtype)
    if space_to_depth:
        x = space_to_depth_2x2(x)
    c = x.shape[-1]
    channels = c if channels is None else channels
    if channels < c:
        raise ValueError(f'pillar_encoder_input: {channels} channels cannot hold the {c} '
                         'the layout has')
    return torch.nn.functional.pad(x, (0, channels - c)) if channels > c else x


pillar_encoder_input = pillar_encoder_input_plain
