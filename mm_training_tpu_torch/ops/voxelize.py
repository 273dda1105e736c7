"""Kernel K1: fixed-shape pillar voxelization + mean VFE, written straight
into the LiDAR encoder's input.

The port of ``mm_training_tpu/ops/voxelize.py::voxelize_pillars_dense``:
floor-quantize points onto the (ny, nx) pillar grid and take the per-pillar
mean of their first ``num_features`` features (empty pillars are zero).
:func:`pillar_encoder_input` also does what
``mm_training_tpu/models/lidar_encoder.py:54-65`` does next: one rounding
to the compute dtype and the 2x2 space-to-depth, and it pads the channels
with zeros up to what the first conv takes. Both entries launch the one
kernel of ``csrc/voxelize.cu`` (a cooperative launch: zero the accumulator,
16-byte atomic adds of each point's row, then the means in the requested
layout); it is bound by device-memory bytes, see the note there.

Points stay float32 whatever the model's compute type: bf16 cannot resolve
0.2 m voxels at 200 m range. Inputs are batched, ``points [B, P, F]``,
``mask [B, P]`` (the JAX function takes one sample and is vmapped).

:func:`sparse_encoder_input` is K1's sparse-input mode, the front of the
sparse-import encoder (``mm_training_tpu/models/sparse_encoder.py:136-150``):
mmdet3d's first-K-points-in-input-order cap inside the kernel (integer
counts, an interval of point indices for each pillar of more than four, the
K smallest selected in time linear in a pillar's points; exact, whatever
order the atomics take), the means at full resolution in the compute dtype,
each summed in ascending input order by one owner (the same bits on every
call), channels-last and padded with zero channels, and the occupancy
``count > 0`` as a [B, 1, ny, nx] bool tensor, the mask operand of kernel
A's masked form.
Its plain version is the JAX package's formulation: the stable-sort rank
(:func:`_first_k_mask`) narrowing the mask, then
:func:`voxelize_pillars_dense_plain` with the count.
:func:`voxelize_pillars_dense` with ``max_points_per_voxel`` is the sparse
mode's float32 grid.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import build

__all__ = ['pillar_encoder_input', 'pillar_encoder_input_plain', 'pillar_segments',
           'sparse_encoder_input', 'sparse_encoder_input_plain', 'voxelize_pillars_dense',
           'voxelize_pillars_dense_plain']

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_FEATURES = 8    # features the kernel averages
MAX_CHANNELS = 32   # output channels a pixel the kernel writes


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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load('voxelize')
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.pillar_encoder_input.argtypes = [p, p, i64, i64, i32, i32, f32, f32, f32, f32, f32,
                                         f32, i32, i32, i32, i32, i32, i32, p, p, p, p]
    lib.pillar_encoder_input.restype = ctypes.c_int
    lib.sparse_encoder_input.argtypes = [p, p, i64, i64, i32, i32, f32, f32, f32, f32, f32,
                                         f32, i32, i32, i32, i32, i32, i32, p, p, p, p, p, p]
    lib.sparse_encoder_input.restype = ctypes.c_int
    lib.sparse_encoder_input_workspace.argtypes = [i64, i64, i32, i32, p, p]
    lib.sparse_encoder_input_workspace.restype = None
    return lib


def _check_points(points: torch.Tensor, mask: torch.Tensor, num_features: int, what: str):
    if points.dim() != 3 or mask.shape != points.shape[:2] or mask.dtype != torch.bool:
        raise ValueError(f'{what}: points [B, P, F] and bool mask [B, P], got '
                         f'{tuple(points.shape)} and {tuple(mask.shape)} {mask.dtype}')
    if points.dtype != torch.float32 or not 3 <= num_features <= points.shape[2]:
        raise ValueError(f'{what}: points must be float32 with at least '
                         f'max(3, num_features={num_features}) features')


def _check_launch(points, mask, num_features, dtype, channels, what):
    """Raise unless kernel K1 takes these: CUDA tensors on one device,
    float32 or bfloat16 out, at most MAX_FEATURES features into at most
    MAX_CHANNELS channels."""
    if points.device.type != 'cuda' or mask.device != points.device:
        raise ValueError(f'{what}: points on {points.device}, mask on {mask.device}')
    if dtype not in _DTYPES or num_features > MAX_FEATURES or channels > MAX_CHANNELS:
        raise ValueError(f'{what}: kernel K1 writes float32 or bfloat16, averages at most '
                         f'{MAX_FEATURES} features into at most {MAX_CHANNELS} channels, got '
                         f'{dtype}, {num_features} features, {channels} channels')


def _launch(points, mask, pc_range, voxel_size, grid_hw, num_features, dtype,
            space_to_depth, channels, what):
    """One launch of the K1 kernel on CUDA tensors -> the output tensor."""
    _check_launch(points, mask, num_features, dtype, channels, what)
    nz = _num_z_bins(pc_range, voxel_size)
    b, p, f = points.shape
    ny, nx = grid_hw
    points, mask = points.contiguous(), mask.contiguous()
    shape = (b, ny // 2, nx // 2, channels) if space_to_depth else (b, ny, nx, channels)
    out = torch.empty(shape, dtype=dtype, device=points.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(points.device).cuda_stream
    row = (num_features + 4) // 4 * 4
    acc, barrier = build.scratch('voxelize', points.device, stream, b * ny * nx * row, 2)
    lib = _lib()
    with torch.cuda.device(points.device):
        code = lib.pillar_encoder_input(
            points.data_ptr(), mask.data_ptr(), b, p, f, num_features,
            pc_range[0], pc_range[1], pc_range[2], voxel_size[0], voxel_size[1],
            voxel_size[2], nx, ny, nz, _DTYPES[dtype], int(space_to_depth), channels,
            acc.data_ptr(), barrier.data_ptr(), out.data_ptr(), stream)
    build.check(lib, code, what)
    return out


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
        each pillar, as mmdet3d's hard voxelizer does: the grid of
        :func:`sparse_encoder_input`.

    Returns [B, ny, nx, num_features] float32. CPU tensors take
    :func:`voxelize_pillars_dense_plain`; CUDA tensors launch the kernel.
    """
    if max_points_per_voxel is not None:
        return sparse_encoder_input(points, mask, pc_range, voxel_size, grid_hw, num_features,
                                    max_points_per_voxel=max_points_per_voxel)[0]
    _check_points(points, mask, num_features, 'voxelize_pillars_dense')
    if points.device.type == 'cpu':
        return voxelize_pillars_dense_plain(points, mask, pc_range, voxel_size,
                                            grid_hw, num_features)
    out = _launch(points, mask, pc_range, voxel_size, grid_hw, num_features, torch.float32,
                  False, num_features, 'voxelize_pillars_dense')
    voxelize_pillars_dense.launches += 1
    return out


voxelize_pillars_dense.launches = 0


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


def pillar_encoder_input(points: torch.Tensor, mask: torch.Tensor,
                         pc_range: Sequence[float], voxel_size: Sequence[float],
                         grid_hw: Tuple[int, int], num_features: int = 5,
                         dtype: torch.dtype = torch.float32, space_to_depth: bool = True,
                         channels: Optional[int] = None) -> torch.Tensor:
    """The LiDAR encoder's input in one launch: the per-pillar mean of
    :func:`voxelize_pillars_dense`, rounded once to ``dtype``, folded by the
    2x2 space-to-depth (``space_to_depth``; channel groups in (row-offset,
    col-offset) order, the feature minor, as the JAX package's
    ``space_to_depth_2x2``), and zero channels after the features up to
    ``channels`` (default: none).

    Returns [B, ny/2, nx/2, channels] (or [B, ny, nx, channels] without
    space-to-depth) in ``dtype``, NHWC-contiguous. CPU tensors take
    :func:`pillar_encoder_input_plain`; CUDA tensors launch kernel K1 once
    (float32 or bfloat16, at most 8 features and 32 channels) or raise."""
    _check_points(points, mask, num_features, 'pillar_encoder_input')
    c = num_features * (4 if space_to_depth else 1)
    channels = c if channels is None else channels
    if channels < c or (space_to_depth and (grid_hw[0] % 2 or grid_hw[1] % 2)):
        raise ValueError(f'pillar_encoder_input: {channels} channels for {c} features on a '
                         f'{tuple(grid_hw)} grid (space-to-depth {space_to_depth} needs it even)')
    if points.device.type == 'cpu':
        return pillar_encoder_input_plain(points, mask, pc_range, voxel_size, grid_hw,
                                          num_features, dtype, space_to_depth, channels)
    out = _launch(points, mask, pc_range, voxel_size, grid_hw, num_features, dtype,
                  space_to_depth, channels, 'pillar_encoder_input')
    pillar_encoder_input.launches += 1
    return out


pillar_encoder_input.launches = 0


def sparse_encoder_input_plain(points: torch.Tensor, mask: torch.Tensor,
                               pc_range: Sequence[float], voxel_size: Sequence[float],
                               grid_hw: Tuple[int, int], num_features: int = 5,
                               dtype: torch.dtype = torch.float32,
                               channels: Optional[int] = None, *,
                               max_points_per_voxel: int, return_kept: bool = False):
    """Plain PyTorch version of :func:`sparse_encoder_input`: the stable-sort
    first-K mask (:func:`_first_k_mask`), :func:`voxelize_pillars_dense_plain`
    with the count, one cast to ``dtype``, zero channels up to
    ``channels``."""
    ny, nx = grid_hw
    keep = _first_k_mask(points, mask, pc_range, voxel_size, grid_hw, max_points_per_voxel)
    kept = keep & (pillar_segments(points, mask, pc_range, voxel_size, grid_hw) < ny * nx)
    grid, count = voxelize_pillars_dense_plain(points, kept, pc_range, voxel_size, grid_hw,
                                               num_features, return_count=True)
    channels = num_features if channels is None else channels
    x = torch.nn.functional.pad(grid.to(dtype), (0, channels - num_features))
    out = (x, (count > 0).permute(0, 3, 1, 2).contiguous())
    return out + (kept,) if return_kept else out


def sparse_encoder_input(points: torch.Tensor, mask: torch.Tensor,
                         pc_range: Sequence[float], voxel_size: Sequence[float],
                         grid_hw: Tuple[int, int], num_features: int = 5,
                         dtype: torch.dtype = torch.float32, channels: Optional[int] = None,
                         *, max_points_per_voxel: int, return_kept: bool = False):
    """The sparse-import encoder's input in one launch (kernel K1's
    sparse-input mode): the per-pillar mean of the first
    ``max_points_per_voxel`` points (K >= 1) of each pillar in input order,
    rounded once to ``dtype``, with zero channels after the
    features up to ``channels`` (default: none), and the occupancy.

    Returns (grid [B, ny, nx, channels] in ``dtype``, NHWC-contiguous; occ
    [B, 1, ny, nx] bool, a pillar with a point), and with ``return_kept``
    the [B, P] bool kept set (the points averaged). CPU tensors take
    :func:`sparse_encoder_input_plain`; CUDA tensors launch the kernel once
    (float32 or bfloat16, at most 8 features and 32 channels, fewer than
    2^31 pillars and points a batch) or raise."""
    _check_points(points, mask, num_features, 'sparse_encoder_input')
    channels = num_features if channels is None else channels
    if channels < num_features:
        raise ValueError(f'sparse_encoder_input: {channels} channels cannot hold '
                         f'{num_features} features')
    if not 1 <= max_points_per_voxel < 2 ** 31:
        raise ValueError(f'sparse_encoder_input: max_points_per_voxel = '
                         f'{max_points_per_voxel}, from 1 to 2^31 - 1')
    if points.device.type == 'cpu':
        return sparse_encoder_input_plain(points, mask, pc_range, voxel_size, grid_hw,
                                          num_features, dtype, channels,
                                          max_points_per_voxel=max_points_per_voxel,
                                          return_kept=return_kept)
    what = 'sparse_encoder_input'
    _check_launch(points, mask, num_features, dtype, channels, what)
    nz = _num_z_bins(pc_range, voxel_size)
    b, p, f = points.shape
    ny, nx = grid_hw
    cells, n_pts = b * ny * nx, b * p
    if cells >= 2 ** 31 or n_pts >= 2 ** 31:
        raise ValueError(f'{what}: {cells} pillars and {n_pts} points, each below 2^31')
    points, mask = points.contiguous(), mask.contiguous()
    out = torch.empty((b, ny, nx, channels), dtype=dtype, device=points.device)
    occ = torch.empty((b, 1, ny, nx), dtype=torch.bool, device=points.device)
    kept = (torch.empty((b, p), dtype=torch.bool, device=points.device) if return_kept
            else None)
    if cells == 0:
        return (out, occ, kept) if return_kept else (out, occ)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    lib = _lib()
    words, zeroed = ctypes.c_longlong(), ctypes.c_longlong()
    lib.sparse_encoder_input_workspace(b, p, nx, ny, ctypes.byref(words), ctypes.byref(zeroed))
    # int32 scratch in the float32 buffer; the zeroed words (the grid
    # barrier's and the per-pillar counts) are zero again after every call
    buf, zero = build.scratch('voxelize_sparse', points.device, stream, words.value,
                              zeroed.value)
    with torch.cuda.device(points.device):
        code = lib.sparse_encoder_input(
            points.data_ptr(), mask.data_ptr(), b, p, f, num_features,
            pc_range[0], pc_range[1], pc_range[2], voxel_size[0], voxel_size[1],
            voxel_size[2], nx, ny, nz, int(max_points_per_voxel), _DTYPES[dtype], channels,
            buf.data_ptr(), zero.data_ptr(), out.data_ptr(), occ.data_ptr(),
            None if kept is None else kept.data_ptr(), stream)
    build.check(lib, code, what)
    sparse_encoder_input.launches += 1
    return (out, occ, kept) if return_kept else (out, occ)


sparse_encoder_input.launches = 0
