"""Frozen copy of the port's ``core/geometry.py`` for the benchmark's reference, run
on its plain path (its kernel calls bound to their plain versions, one
process). The text below is the original's.

Frustum / lift-splat geometry, in float32 torch.

The port of ``mm_training_tpu/core/geometry.py`` (:18-101): the image-plane
frustum (numpy, built once), its transform to ego coordinates with each
request's calibration, and the quantization to BEV cells. Everything stays
float32: at 200 m range a bf16 (or TF32) rounding moves a frustum point by
about a metre, across cells. The products are elementwise float32 ops in a
fixed order (no matrix-product library, no convolution, so no TF32 and no
device-dependent summation order).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ['create_frustum', 'get_geometry', 'quantize_geometry', 'flat_bev_index',
           'rig_is_row_independent']


def create_frustum(d_bound: Sequence[float], final_dim: Tuple[int, int],
                   downsample_factor: int) -> np.ndarray:
    """[D, fH, fW, 3] float32 frustum of (u, v, d) image-plane points: depths
    ``arange(*d_bound)``; pixel coordinates ``linspace(0, W-1, fW)`` x
    ``linspace(0, H-1, fH)`` in input-image pixels."""
    ogf_h, ogf_w = final_dim
    f_h, f_w = ogf_h // downsample_factor, ogf_w // downsample_factor
    d = np.arange(d_bound[0], d_bound[1], d_bound[2], dtype=np.float32)
    depth = d[:, None, None] * np.ones((1, f_h, f_w), np.float32)
    x = np.linspace(0, ogf_w - 1, f_w, dtype=np.float32)[None, None, :] * np.ones_like(depth)
    y = np.linspace(0, ogf_h - 1, f_h, dtype=np.float32)[None, :, None] * np.ones_like(depth)
    return np.stack([x, y, depth], axis=-1)


def _mat_vec(m: torch.Tensor, terms) -> torch.Tensor:
    """Rows of ``m`` [..., R, 4] times the 4-vector ``terms``, each row's
    dot product written out left to right (no FMA: the same bits on every
    device)."""
    return torch.stack([((terms[0] * m[..., i, 0] + terms[1] * m[..., i, 1])
                         + terms[2] * m[..., i, 2]) + terms[3] * m[..., i, 3]
                        for i in range(m.shape[-2])], dim=-1)


def get_geometry(frustum: torch.Tensor, sensor2ego: torch.Tensor,
                 intrin: torch.Tensor) -> torch.Tensor:
    """Frustum [D, fH, fW, 3] -> ego xyz [B, N, D, fH, fW, 3] (float32):
    homogeneous (u*d, v*d, d, 1) times ``sensor2ego @ inv(intrin)``, both
    [B, N, 4, 4]. The products are written out in one order, so the card
    and the CPU place a frustum point on the same side of a cell edge."""
    u = frustum[..., 0] * frustum[..., 2]
    v = frustum[..., 1] * frustum[..., 2]
    d = frustum[..., 2]
    # inv_ex: no host wait on the error flag (the matrices are calibration)
    k_inv = torch.linalg.inv_ex(intrin.float())[0]
    s2e = sensor2ego.float()
    combine = torch.stack([_mat_vec(s2e, [k_inv[..., k, j] for k in range(4)])
                           for j in range(4)], dim=-1)                    # [B, N, 4, 4]
    c = combine[:, :, :3, None, None, None, :]                            # rows x, y, z
    return torch.stack([((u * c[:, :, i, ..., 0] + v * c[:, :, i, ..., 1])
                         + d * c[:, :, i, ..., 2]) + c[:, :, i, ..., 3]
                        for i in range(3)], dim=-1)


def quantize_geometry(geom_xyz: torch.Tensor, voxel_coord: Sequence[float],
                      voxel_size: Sequence[float]) -> torch.Tensor:
    """Ego xyz -> int32 voxel indices ``int((xyz - (vc - vs/2)) / vs)``.

    The cast truncates toward zero, as the reference's ``.int()`` does, so
    coordinates up to one voxel below the grid land in voxel 0 and pass the
    range mask (``floor`` would send them to -1). The division is a product
    with the float32 reciprocal of the voxel size, as the JAX package
    computes it once compiled: XLA rewrites a division by a constant into
    that product, which moves about 1% of the frustum points of the tiny
    test geometry across a cell edge against a true division."""
    vc = torch.tensor(voxel_coord, dtype=torch.float32, device=geom_xyz.device)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=geom_xyz.device)
    return ((geom_xyz - (vc - vs / 2.0)) * (1.0 / vs)).to(torch.int32)


def flat_bev_index(geom_idx: torch.Tensor, voxel_num: Sequence[int]) -> torch.Tensor:
    """Integer voxel xyz [..., 3] -> flat BEV cell ``y * nx + x`` [...] int32,
    out-of-range -> ``nx * ny`` (the trash bin)."""
    nx, ny, nz = voxel_num
    x, y, z = geom_idx[..., 0], geom_idx[..., 1], geom_idx[..., 2]
    valid = (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0) & (z < nz)
    return torch.where(valid, y * nx + x, nx * ny).to(torch.int32)


def rig_is_row_independent(sensor2ego, intrin, tol: float = 1e-5) -> bool:
    """True iff the BEV (x, y) of every frustum point is independent of the
    image row, the exactness condition of the factorized splat: column 1 of
    ``sensor2ego @ inv(intrin)`` has zero x and y. Host numpy (float64),
    once per rig."""
    s2e = np.asarray(sensor2ego, np.float64).reshape(-1, 4, 4)
    k = np.asarray(intrin, np.float64).reshape(-1, 4, 4)
    combine = s2e @ np.linalg.inv(k)
    return bool(np.all(np.abs(combine[:, 0:2, 1]) < tol))
