"""Kernel K4: the row-factorized lift-splat of the camera branch.

The port of ``mm_training_tpu/ops/voxel_pooling.py::lift_splat_factorized``
(:127-169). For a zero-roll/pitch (virtualized) camera a frustum point's
BEV (x, y) cell depends on its depth bin and image column only, so the
splat factorizes exactly:

    A[m, d, w, c] = sum_h depth[m, d, h, w] * zvalid[m, d, h, w] * ctx[m, h, w, c]
    bev[m, g, c]  = sum over (d, w) with idx[m, d, w] == g of A[m, d, w, c]

accumulated in float32 and returned in the compute dtype (``ctx``'s), the
trash cell ``n_cells`` dropped. The CUDA source is ``csrc/lift_splat.cu``;
it never writes the [M, D, fW, C] slab, see the note there. The raw-rig
``lift_splat`` (no factorization) is not ported yet.

There is no backward yet (serving runs under ``inference_mode``): the
training slice adds one. Until then a CUDA call that needs a gradient
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ['lift_splat_factorized', 'lift_splat_factorized_plain', 'splat_atomic_adds']

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def lift_splat_factorized_plain(depth: torch.Tensor, ctx: torch.Tensor,
                                flat_idx_xy: torch.Tensor, zvalid: torch.Tensor,
                                n_cells: int) -> torch.Tensor:
    """Plain PyTorch version: an fp32 einsum over the rows, then one
    ``index_add_`` of the M*D*fW rows into M*(n_cells+1) cells."""
    m, d, fh, fw = depth.shape
    c = ctx.shape[-1]
    masked = depth * zvalid.to(depth.dtype)
    a = torch.einsum('mdhw,mhwc->mdwc', masked.float(), ctx.float())    # [M,D,fW,C]
    seg = (flat_idx_xy.long()
           + (n_cells + 1) * torch.arange(m, device=depth.device)[:, None, None])
    out = torch.zeros(m * (n_cells + 1), c, dtype=torch.float32, device=depth.device)
    out.index_add_(0, seg.reshape(-1), a.reshape(m * d * fw, c))
    return out.to(ctx.dtype).reshape(m, n_cells + 1, c)[:, :n_cells]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load('lift_splat')
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lift_splat.argtypes = [i32, p, i64, i64, i64, i64, p, i64, i64, i64, i64, p, p,
                               i32, i32, i32, i32, i32, i32, p, p, p, p, p]
    lib.lift_splat.restype = ctypes.c_int
    return lib


def lift_splat_factorized(depth: torch.Tensor, ctx: torch.Tensor,
                          flat_idx_xy: torch.Tensor, zvalid: torch.Tensor,
                          n_cells: int) -> torch.Tensor:
    """Row-factorized splat of every camera.

    Args:
      depth: [M, D, fH, fW] depth distributions (or the one-hot oracle).
      ctx: [M, fH, fW, C] context features, of depth's dtype.
      flat_idx_xy: [M, D, fW] int32 BEV cell of each (bin, column), in
        [0, n_cells] (n_cells = out of the grid).
      zvalid: [M, D, fH, fW] bool, the frustum point's z inside the grid.
      n_cells: ny * nx.

    Returns [M, n_cells, C] in ctx's dtype. A CPU tensor takes
    :func:`lift_splat_factorized_plain`; a CUDA tensor launches kernel K4
    (one launch; depth and ctx in any strides, C a multiple of 8 up to 128,
    fH up to 64, and for float32 not both at their largest: the tile then
    outgrows shared memory) or raises (also when a gradient is asked for: no
    backward yet)."""
    return _splat(depth, ctx, flat_idx_xy, zvalid, n_cells)


def splat_atomic_adds(depth: torch.Tensor, ctx: torch.Tensor, flat_idx_xy: torch.Tensor,
                      zvalid: torch.Tensor, n_cells: int):
    """Launch kernel K4 as :func:`lift_splat_factorized` does, on CUDA
    tensors, and count its float atomics on the card. Returns (scalar adds
    the merged runs stand for: kept (camera, bin, column) rows x C, 16-byte
    adds issued)."""
    if depth.device.type != 'cuda':
        raise ValueError('splat_atomic_adds: kernel K4 counts its adds on a CUDA device')
    adds = torch.zeros(2, dtype=torch.int64, device=depth.device)
    _splat(depth, ctx, flat_idx_xy, zvalid, n_cells, adds)
    before, after = adds.tolist()
    return before, after


def _splat(depth, ctx, flat_idx_xy, zvalid, n_cells, adds=None):
    m, d, fh, fw = depth.shape
    c = ctx.shape[-1]
    if (ctx.shape != (m, fh, fw, c) or flat_idx_xy.shape != (m, d, fw)
            or zvalid.shape != depth.shape or zvalid.dtype != torch.bool
            or ctx.dtype != depth.dtype):
        raise ValueError(f'lift_splat_factorized: depth [M, D, fH, fW], ctx [M, fH, fW, C] '
                         f'of its dtype, idx [M, D, fW], bool zvalid like depth; got '
                         f'{tuple(depth.shape)} {depth.dtype}, {tuple(ctx.shape)} '
                         f'{ctx.dtype}, {tuple(flat_idx_xy.shape)}, {tuple(zvalid.shape)} '
                         f'{zvalid.dtype}')
    if depth.device.type == 'cpu':
        return lift_splat_factorized_plain(depth, ctx, flat_idx_xy, zvalid, n_cells)
    tensors = (depth, ctx, flat_idx_xy, zvalid)
    if (depth.device.type != 'cuda' or depth.dtype not in _DTYPES
            or flat_idx_xy.dtype != torch.int32
            or any(t.device != depth.device for t in tensors)):
        raise ValueError('lift_splat_factorized: float32/bfloat16 depth and ctx, int32 '
                         'indices and bool zvalid, all on one CUDA device or the CPU')
    if c % 8 or not 8 <= c <= 128 or fh > 64:
        raise ValueError(f'lift_splat_factorized: kernel K4 takes C a multiple of 8 up to '
                         f'128 and fH up to 64, got C={c}, fH={fh}')
    if torch.is_grad_enabled() and (depth.requires_grad or ctx.requires_grad):
        raise NotImplementedError('lift_splat_factorized: kernel K4 has no backward yet; '
                                  'it arrives with the camera training slice (slice 4)')
    out = torch.empty(m, n_cells, c, dtype=ctx.dtype, device=depth.device)
    if out.numel() == 0:
        return out
    # the path's own indices and mask are contiguous already: no copy there
    flat_idx_xy, zvalid = flat_idx_xy.contiguous(), zvalid.contiguous()
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    acc, barrier = build.scratch('lift_splat', depth.device, stream, out.numel(), 2)
    lib = _lib()
    with torch.cuda.device(depth.device):
        code = lib.lift_splat(_DTYPES[depth.dtype], depth.data_ptr(), *depth.stride(),
                              ctx.data_ptr(), *ctx.stride(), flat_idx_xy.data_ptr(),
                              zvalid.data_ptr(), m, d, fh, fw, c, n_cells, acc.data_ptr(),
                              barrier.data_ptr(), out.data_ptr(),
                              None if adds is None else adds.data_ptr(), stream)
    build.check(lib, code, 'lift_splat_factorized')
    lift_splat_factorized.launches += 1
    return out


lift_splat_factorized.launches = 0
