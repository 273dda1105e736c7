"""Kernel K6: depth labels from the LiDAR (the lift's depth oracle).

The port of ``mm_training_tpu/ops/depth_labels.py``: ``depth_labels``
(:89-96, ``depth_labels_single_cam`` vmapped over the cameras, :30-73) and
``depth_grid_to_onehot`` (:76-86), the one binning function that the
projection path and a precomputed ``depth_gt`` grid share. The CUDA source
is ``csrc/depth_labels.cu``: one launch a call, one thread-block cluster a
camera holding the camera's min-depth grid in its shared memory; it is
bound by the bytes of the one-hot labels it writes, see the note there.

The projection is computed in float32 with the dot products written out in
one order (``((x*e0 + y*e1) + z*e2) + 1*e3``) in both versions, so the
kernel and the plain version give the same bits on the card; divisions are
true divisions (by a tensor, never a Python number, which PyTorch's CUDA
path turns into a multiply by the reciprocal), and the int casts truncate.
Cells no kept point reaches hold 1e5 (the JAX segment-min leaves +inf
there); both bin to 0.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build
from .gaussian import true_div

__all__ = ['depth_labels', 'depth_labels_plain', 'depth_grid_to_onehot',
           'depth_grid_to_onehot_plain', 'max_cells', 'min_depth_grid_plain']

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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load('depth_labels')
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.depth_labels.argtypes = [p, i64, i64, p, p, i64, i64, p, i64, i64, i64, i64, i32,
                                 i32, i32, i32, i32, i32, i32, f32, f32, p, p]
    lib.depth_labels.restype = ctypes.c_int
    lib.depth_labels_max_cells.argtypes = []
    lib.depth_labels_max_cells.restype = ctypes.c_longlong
    lib.depth_onehot.argtypes = [p, p, i64, i32, f32, f32, p]
    lib.depth_onehot.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def max_cells(device: torch.device) -> int:
    """Cells of one camera's min-depth grid that fit in one thread-block
    cluster's shared memory on ``device`` (the kernel keeps the grid
    there)."""
    lib = _lib()
    with torch.cuda.device(device):
        return int(lib.depth_labels_max_cells())


def _bin_edges(d_bound: Sequence[float]) -> Tuple[float, float]:
    """(d0 - step, step) as the float32 values the JAX binning uses."""
    d0, _, step = d_bound
    return float(torch.tensor(d0 - step, dtype=torch.float32)), \
        float(torch.tensor(step, dtype=torch.float32))


def depth_labels(points: torch.Tensor, mask: torch.Tensor, extrinsics: torch.Tensor,
                 intrinsics: torch.Tensor, img_hw: Tuple[int, int], downsample: int,
                 d_bound: Sequence[float], num_bins: int) -> torch.Tensor:
    """One-hot depth labels of every camera of every sample.

    Args:
      points: [B, P, F] float32 ego-frame points (x, y, z first; the caller
        un-rotates the BEV augmentation first), mask [B, P] bool.
      extrinsics, intrinsics: [B, N, 4, 4] float32 (body->camera, camera).
      img_hw: the network input image (H, W); downsample: 16.
      d_bound: (d0, d1, step); num_bins: D.

    Returns [B*N, H/ds, W/ds, D] float32. A CPU tensor takes
    :func:`depth_labels_plain`; a CUDA tensor launches kernel K6 or raises.
    Points and matrices are read in place (strided views welcome, x, y, z
    and each 4 x 4 contiguous); a camera's H/ds x W/ds grid must fit in one
    cluster's shared memory (:func:`max_cells`), else ValueError.
    """
    b, p = mask.shape
    if (points.dim() != 3 or points.shape[:2] != (b, p) or points.shape[2] < 3
            or mask.dtype != torch.bool or extrinsics.shape[0] != b
            or extrinsics.shape[2:] != (4, 4) or intrinsics.shape != extrinsics.shape):
        raise ValueError(f'depth_labels: points [B, P, F>=3], bool mask [B, P], matrices '
                         f'[B, N, 4, 4]; got {tuple(points.shape)}, {tuple(mask.shape)} '
                         f'{mask.dtype}, {tuple(extrinsics.shape)}, '
                         f'{tuple(intrinsics.shape)}')
    if points.device.type == 'cpu':
        return depth_labels_plain(points, mask, extrinsics, intrinsics, img_hw,
                                  downsample, d_bound, num_bins)
    tensors = (points, mask, extrinsics, intrinsics)
    if points.device.type != 'cuda' or any(t.device != points.device for t in tensors) \
            or any(t.dtype != torch.float32 for t in (points, extrinsics, intrinsics)):
        raise ValueError('depth_labels: float32 points and matrices and a bool mask, '
                         'all on one CUDA device or all on the CPU')
    if points.stride(2) != 1:
        points = points.contiguous()
    extrinsics, intrinsics = (m if m.stride()[2:] == (4, 1) else m.contiguous()
                              for m in (extrinsics, intrinsics))
    mask = mask.contiguous()
    n = extrinsics.shape[1]
    h, w = img_hw
    fh, fw = h // downsample, w // downsample
    if fh * fw > max_cells(points.device):
        raise ValueError(f'depth_labels: a camera grid of {fh} x {fw} cells (image {h} x {w}, '
                         f'downsample {downsample}) does not fit in one thread-block '
                         f"cluster's shared memory ({max_cells(points.device)} cells)")
    out = torch.empty(b * n, fh, fw, num_bins, dtype=torch.float32, device=points.device)
    lo, step = _bin_edges(d_bound)
    lib = _lib()
    with torch.cuda.device(points.device):
        code = lib.depth_labels(points.data_ptr(), points.stride(0), points.stride(1),
                                mask.data_ptr(), extrinsics.data_ptr(), extrinsics.stride(0),
                                extrinsics.stride(1), intrinsics.data_ptr(),
                                intrinsics.stride(0), intrinsics.stride(1), b, p, n, h, w,
                                downsample, fh, fw, num_bins, lo, step, out.data_ptr(),
                                torch.cuda.current_stream(points.device).cuda_stream)
    build.check(lib, code, 'depth_labels')
    depth_labels.launches += 1
    return out


depth_labels.launches = 0


def depth_grid_to_onehot(grid: torch.Tensor, d_bound: Sequence[float],
                         num_bins: int) -> torch.Tensor:
    """Min-depth grid [...] float32 (0 or >= 1e5 = empty; the format of a
    precomputed ``depth_gt``) -> one-hot labels [..., num_bins] float32:
    bin ``int((g - (d0 - step)) / step)``, out of [0, num_bins) -> bin 0.

    A CPU tensor takes :func:`depth_grid_to_onehot_plain`; a CUDA tensor
    launches kernel K6's binning pass or raises."""
    if grid.device.type == 'cpu':
        return depth_grid_to_onehot_plain(grid, d_bound, num_bins)
    if grid.device.type != 'cuda' or grid.dtype != torch.float32:
        raise ValueError(f'depth_grid_to_onehot takes a float32 CUDA or CPU grid, got '
                         f'{grid.dtype} on {grid.device}')
    grid = grid.contiguous()
    out = torch.empty(*grid.shape, num_bins, dtype=torch.float32, device=grid.device)
    lo, step = _bin_edges(d_bound)
    lib = _lib()
    with torch.cuda.device(grid.device):
        code = lib.depth_onehot(grid.data_ptr(), out.data_ptr(), grid.numel(), num_bins,
                                lo, step, torch.cuda.current_stream(grid.device).cuda_stream)
    build.check(lib, code, 'depth_grid_to_onehot')
    depth_grid_to_onehot.launches += 1
    return out


depth_grid_to_onehot.launches = 0
