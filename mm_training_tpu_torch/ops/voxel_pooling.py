"""Kernels K4 and K8: the lift-splat of the camera branch, row-factorized
for a virtualized rig and general for a raw one.

The port of ``mm_training_tpu/ops/voxel_pooling.py::lift_splat_factorized``
(:127-169). For a zero-roll/pitch (virtualized) camera a frustum point's
BEV (x, y) cell depends on its depth bin and image column only, so the
splat factorizes exactly:

    A[m, d, w, c] = sum_h depth[m, d, h, w] * zvalid[m, d, h, w] * ctx[m, h, w, c]
    bev[m, g, c]  = sum over (d, w) with idx[m, d, w] == g of A[m, d, w, c]

accumulated in float32 and returned in the compute dtype (``ctx``'s), the
trash cell ``n_cells`` dropped. The CUDA source is ``csrc/lift_splat.cu``;
it never writes the [M, D, fW, C] slab, see the note there.

Kernel K8 (``csrc/lift_splat_raw.cu``) is the port of the raw-rig
``lift_splat`` (:83-112), which a rig with roll, pitch or intrinsic skew
needs: per camera the products ``depth[d, p] * ctx[p, :]`` in the compute
dtype (each rounded to bf16 in bf16, as the JAX package's slab is),
segment-summed in float32 into ``n_cells + 1`` cells, the trash cell
dropped, cast to ctx's dtype. It puts the kept rows in cell order first
(intervals, as BEVPoolv2 does) and sums each cell once, no float atomics;
:func:`lift_splat_intervals_plain` is that algorithm in plain PyTorch, for
the CPU tests (the oracle of the kernel is :func:`lift_splat_plain`). Its
backward K8' gathers the output gradient's rows by cell (d depth, d ctx),
every output written once; :class:`LiftSplatRaw` joins the two.

Its backward, kernel K4' (``csrc/lift_splat_backward.cu``), gathers the
output gradient by cell once (zero for the trash cell) and contracts it
with ctx (d depth, masked by zvalid) and with the masked depth (d ctx):
bf16 on the tensor cores, fp32 sums in a fixed order, every output written
once. :class:`LiftSplat` joins the two as a
``torch.autograd.Function``, which :func:`lift_splat_factorized` takes for
a CUDA call that needs a gradient; on the CPU the plain version is
differentiated by autograd, as XLA differentiates the JAX formulation.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ['LiftSplat', 'LiftSplatRaw', 'RAW_CHUNK', 'RAW_MAX_C', 'lift_splat',
           'lift_splat_backward', 'lift_splat_backward_plain', 'lift_splat_factorized',
           'lift_splat_factorized_backward', 'lift_splat_factorized_backward_plain',
           'lift_splat_factorized_plain', 'lift_splat_plain',
           'raw_splat_atomic_adds', 'splat_atomic_adds']

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K8 and K8' keep 8 channels a lane; K8' a warp per 8 channels of a block
RAW_MAX_C = 256
# entries a work unit of K8 sums at most: a longer cell is cut into
# ceil(count / RAW_CHUNK) near-equal chunks (at least RAW_MAX_C / 2 entries
# each, the room a chunk's float32 partial takes over its own entries)
RAW_CHUNK = 256


def lift_splat_factorized_plain(depth: torch.Tensor, ctx: torch.Tensor,
                                flat_idx_xy: torch.Tensor, zvalid: torch.Tensor,
                                n_cells: int) -> torch.Tensor:
    """Plain PyTorch version: an einsum over the rows rounded to float32,
    then one float32 ``index_add_`` of the M*D*fW rows into M*(n_cells+1)
    cells. The einsum computes in float32 (float64 for float64 inputs) and
    rounds its result to float32, where the JAX package's
    ``preferred_element_type=jnp.float32`` rounds it (also under x64)."""
    m, d, fh, fw = depth.shape
    c = ctx.shape[-1]
    masked = depth * zvalid.to(depth.dtype)
    ct = torch.promote_types(depth.dtype, torch.float32)
    a = torch.einsum('mdhw,mhwc->mdwc', masked.to(ct), ctx.to(ct)).float()   # [M,D,fW,C]
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
    outgrows shared memory) or raises. A CUDA call that needs a gradient
    goes through :class:`LiftSplat`, whose backward is kernel K4'."""
    _check(depth, ctx, flat_idx_xy, zvalid)
    if depth.device.type == 'cpu':
        return lift_splat_factorized_plain(depth, ctx, flat_idx_xy, zvalid, n_cells)
    if torch.is_grad_enabled() and (depth.requires_grad or ctx.requires_grad):
        return LiftSplat.apply(depth, ctx, flat_idx_xy, zvalid, n_cells)
    return _splat(depth, ctx, flat_idx_xy, zvalid, n_cells)


def splat_atomic_adds(depth: torch.Tensor, ctx: torch.Tensor, flat_idx_xy: torch.Tensor,
                      zvalid: torch.Tensor, n_cells: int):
    """Launch kernel K4 as :func:`lift_splat_factorized` does, on CUDA
    tensors, and count its float atomics on the card. Returns (scalar adds
    the merged runs stand for: kept (camera, bin, column) rows x C, 16-byte
    adds issued)."""
    if depth.device.type != 'cuda':
        raise ValueError('splat_atomic_adds: kernel K4 counts its adds on a CUDA device')
    _check(depth, ctx, flat_idx_xy, zvalid)
    adds = torch.zeros(2, dtype=torch.int64, device=depth.device)
    _splat(depth, ctx, flat_idx_xy, zvalid, n_cells, adds)
    before, after = adds.tolist()
    return before, after


def _check(depth, ctx, flat_idx_xy, zvalid):
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


def _check_cuda(depth, ctx, flat_idx_xy, zvalid, what='lift_splat_factorized'):
    c, fh = ctx.shape[-1], depth.shape[2]
    tensors = (depth, ctx, flat_idx_xy, zvalid)
    if (depth.device.type != 'cuda' or depth.dtype not in _DTYPES
            or flat_idx_xy.dtype != torch.int32
            or any(t.device != depth.device for t in tensors)):
        raise ValueError(f'{what}: float32/bfloat16 depth and ctx, int32 indices and bool '
                         'zvalid, all on one CUDA device or the CPU')
    if c % 8 or not 8 <= c <= 128 or fh > 64:
        raise ValueError(f'{what}: kernel K4 takes C a multiple of 8 up to 128 and fH up to '
                         f'64, got C={c}, fH={fh}')


def _splat(depth, ctx, flat_idx_xy, zvalid, n_cells, adds=None):
    """One launch of kernel K4 on CUDA tensors."""
    _check_cuda(depth, ctx, flat_idx_xy, zvalid)
    m, d, fh, fw = depth.shape
    c = ctx.shape[-1]
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


def lift_splat_factorized_backward_plain(g: torch.Tensor, depth: torch.Tensor, ctx: torch.Tensor,
                                         flat_idx_xy: torch.Tensor, zvalid: torch.Tensor,
                                         n_cells: int):
    """Plain PyTorch version of :func:`lift_splat_factorized_backward`:
    autograd through :func:`lift_splat_factorized_plain`."""
    with torch.enable_grad():
        dep = depth.detach().requires_grad_()
        cx = ctx.detach().requires_grad_()
        out = lift_splat_factorized_plain(dep, cx, flat_idx_xy, zvalid, n_cells)
        d_depth, d_ctx = torch.autograd.grad(out, (dep, cx), g)
    return d_depth, d_ctx


@functools.lru_cache(maxsize=None)
def _lib_backward() -> ctypes.CDLL:
    lib = build.load('lift_splat_backward')
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lift_splat_backward.argtypes = [i32, p, i64, i64, i64, p, i64, i64, i64, i64,
                                        p, i64, i64, i64, i64, p, p, p, i64, i64, i64, i64,
                                        p, i64, i64, i64, i64, i32, i32, i32, i32, i32, i32, i32,
                                        p]
    lib.lift_splat_backward.restype = ctypes.c_int
    return lib


def lift_splat_factorized_backward(g: torch.Tensor, depth: torch.Tensor, ctx: torch.Tensor,
                                   flat_idx_xy: torch.Tensor, zvalid: torch.Tensor,
                                   n_cells: int):
    """Gradients (d depth, d ctx) of :func:`lift_splat_factorized` for the
    output gradient ``g`` [M, n_cells, C] (of ctx's dtype, any strides), in
    depth's and ctx's dtypes:

        G[m, d, w] = g[m, idx[m, d, w]]  (zero for the trash cell)
        d depth[m, d, h, w] = zvalid * sum_c ctx[m, h, w, c] G[m, d, w, c]
        d ctx[m, h, w, c]   = sum_d zvalid * depth[m, d, h, w] G[m, d, w, c]

    A CPU tensor takes :func:`lift_splat_factorized_backward_plain`; a CUDA
    tensor launches kernel K4' once (bf16 products on the tensor cores, fp32
    sums in a fixed order, each output written once, no atomics; C a
    multiple of 8 up to 128, fH up to 64) or raises."""
    _check(depth, ctx, flat_idx_xy, zvalid)
    m, d, fh, fw = depth.shape
    c = ctx.shape[-1]
    if g.shape != (m, n_cells, c) or g.dtype != ctx.dtype or g.device != depth.device:
        raise ValueError(f'lift_splat_factorized_backward: g [M, n_cells, C] = '
                         f'{(m, n_cells, c)} of ctx\'s dtype and device, got {tuple(g.shape)} '
                         f'{g.dtype} on {g.device}')
    if depth.device.type == 'cpu':
        return lift_splat_factorized_backward_plain(g, depth, ctx, flat_idx_xy, zvalid,
                                                    n_cells)
    _check_cuda(depth, ctx, flat_idx_xy, zvalid, 'lift_splat_factorized_backward')
    d_depth, d_ctx = torch.empty_like(depth), torch.empty_like(ctx)
    flat_idx_xy, zvalid = flat_idx_xy.contiguous(), zvalid.contiguous()
    # g's rows by 16-byte copies when its channels are contiguous and aligned
    es = g.element_size()
    g_vec = int(g.stride(2) == 1 and g.data_ptr() % 16 == 0
                and all(st * es % 16 == 0 for st in g.stride()[:2]))
    lib = _lib_backward()
    with torch.cuda.device(depth.device):
        code = lib.lift_splat_backward(
            _DTYPES[depth.dtype], g.data_ptr(), *g.stride(), depth.data_ptr(), *depth.stride(),
            ctx.data_ptr(), *ctx.stride(), flat_idx_xy.data_ptr(), zvalid.data_ptr(),
            d_depth.data_ptr(), *d_depth.stride(), d_ctx.data_ptr(), *d_ctx.stride(), m, d, fh,
            fw, c, n_cells, g_vec, torch.cuda.current_stream(depth.device).cuda_stream)
    build.check(lib, code, 'lift_splat_factorized_backward')
    lift_splat_factorized_backward.launches += 1
    return d_depth, d_ctx


lift_splat_factorized_backward.launches = 0


class LiftSplat(torch.autograd.Function):
    """:func:`lift_splat_factorized` with a gradient on the card: the forward
    is kernel K4, the backward :func:`lift_splat_factorized_backward`
    (kernel K4'). The indices and the z mask are data: no gradient.

    ``LiftSplat.apply(depth, ctx, flat_idx_xy, zvalid, n_cells)``."""

    @staticmethod
    def forward(fctx, depth, ctx, flat_idx_xy, zvalid, n_cells):
        fctx.n_cells = n_cells
        fctx.save_for_backward(depth, ctx, flat_idx_xy, zvalid)
        return _splat(depth, ctx, flat_idx_xy, zvalid, n_cells)

    @staticmethod
    def backward(fctx, g):
        depth, ctx, flat_idx_xy, zvalid = fctx.saved_tensors
        d_depth, d_ctx = lift_splat_factorized_backward(g, depth, ctx, flat_idx_xy, zvalid,
                                                        fctx.n_cells)
        return d_depth, d_ctx, None, None, None


# ------------------------------------------------------------------- K8, K8'

def lift_splat_plain(depth: torch.Tensor, ctx: torch.Tensor, flat_idx: torch.Tensor,
                     n_cells: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`lift_splat`, the JAX package's steps
    camera by camera: the rows ``depth[d, p] * ctx[p, :]`` in the inputs'
    dtype (each product rounded to it), raised to float32 and
    ``index_add_``ed into ``n_cells + 1`` cells, the trash cell dropped,
    cast to ctx's dtype."""
    m, d, p = depth.shape
    c = ctx.shape[-1]
    outs = []
    for i in range(m):
        rows = (depth[i, :, :, None] * ctx[i, None]).reshape(d * p, c)
        acc = torch.zeros(n_cells + 1, c, dtype=torch.float32, device=depth.device)
        acc.index_add_(0, flat_idx[i].reshape(-1).long(), rows.float())
        outs.append(acc[:n_cells].to(ctx.dtype))
    return torch.stack(outs)


def lift_splat_intervals_plain(depth: torch.Tensor, ctx: torch.Tensor, flat_idx: torch.Tensor,
                               n_cells: int, chunk: int = RAW_CHUNK) -> torch.Tensor:
    """Kernel K8's algorithm in plain PyTorch, the same function as
    :func:`lift_splat_plain`: count the kept rows of each (camera, cell),
    take the exclusive prefix sum of the counts as the cells' intervals,
    scatter the rows into cell order (stably: a cell's rows in row order),
    cut each interval into ``ceil(count / chunk)`` near-equal chunks, sum
    each chunk's products (rounded to the inputs' dtype) in float32 in row
    order, and add a cell's chunk sums in chunk order; cast to ctx's
    dtype. An empty cell is zero. K8 takes a cell's entries in the order
    of its scatter's atomics, not row order, so the two agree to float32
    rounding, not bit for bit. Not on any path: it guards the algorithm in
    the tests on a host with no card."""
    m, d, p = depth.shape
    c = ctx.shape[-1]
    dev = depth.device
    cell = flat_idx.reshape(m, d * p).long()
    kept = (cell >= 0) & (cell < n_cells)
    cam, row = kept.nonzero(as_tuple=True)                       # row order
    key = cell[cam, row] + n_cells * cam                         # (camera, cell)
    counts = torch.bincount(key, minlength=m * n_cells)
    start = torch.cumsum(counts, 0) - counts
    order = torch.argsort(key, stable=True)                      # cell order
    key, cam, row = key[order], cam[order], row[order]
    rank = torch.arange(key.numel(), device=dev) - start[key]
    chunks = torch.div(counts + chunk - 1, chunk, rounding_mode='floor')
    n, total = chunks[key], counts[key]
    j = torch.div((rank + 1) * n - 1, total, rounding_mode='floor')   # the entry's chunk
    first = torch.cumsum(chunks, 0) - chunks
    prods = depth.reshape(m, d * p)[cam, row, None] * ctx[cam, row % p]
    part = torch.zeros(int(chunks.sum()), c, dtype=torch.float32, device=dev)
    part.index_add_(0, first[key] + j, prods.float())
    out = torch.zeros(m * n_cells, c, dtype=torch.float32, device=dev)
    for jj in range(int(chunks.max()) if chunks.numel() else 0):
        sel = (chunks > jj).nonzero(as_tuple=True)[0]
        out[sel] += part[first[sel] + jj]
    return out.to(ctx.dtype).reshape(m, n_cells, c)


@functools.lru_cache(maxsize=None)
def _lib_raw() -> ctypes.CDLL:
    lib = build.load('lift_splat_raw')
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lift_splat_raw.argtypes = [i32, p, i64, i64, i64, p, i64, i64, i64, i32, p,
                                   i32, i32, i32, i32, i32, i32, p, p, p, p, p]
    lib.lift_splat_raw.restype = ctypes.c_int
    lib.lift_splat_raw_workspace.argtypes = [i32, i32, i32, i32, i32, i32, i32]
    lib.lift_splat_raw_workspace.restype = i64
    lib.lift_splat_raw_backward.argtypes = [i32, p, i64, i64, i32, p, i64, i64, i64,
                                            p, i64, i64, i64, p, p, i64, i64, i64,
                                            p, i64, i64, i64, i32, i32, i32, i32, i32, p]
    lib.lift_splat_raw_backward.restype = ctypes.c_int
    return lib


def _check_raw(depth, ctx, flat_idx, what='lift_splat'):
    m, d, p = depth.shape
    c = ctx.shape[-1]
    if (ctx.shape != (m, p, c) or flat_idx.shape != (m, d, p) or ctx.dtype != depth.dtype
            or flat_idx.dtype not in (torch.int32, torch.int64)):
        raise ValueError(f'{what}: depth [M, D, P], ctx [M, P, C] of its dtype, integer idx '
                         f'[M, D, P]; got {tuple(depth.shape)} {depth.dtype}, '
                         f'{tuple(ctx.shape)} {ctx.dtype}, {tuple(flat_idx.shape)} '
                         f'{flat_idx.dtype}')
    if depth.device.type == 'cpu':
        return
    if (depth.device.type != 'cuda' or depth.dtype not in _DTYPES
            or flat_idx.dtype != torch.int32
            or any(t.device != depth.device for t in (ctx, flat_idx))):
        raise ValueError(f'{what}: float32/bfloat16 depth and ctx and int32 indices, all on '
                         'one CUDA device or the CPU')
    if c % 8 or not 8 <= c <= RAW_MAX_C:
        raise ValueError(f'{what}: kernels K8 and K8\' take C a multiple of 8 up to '
                         f'{RAW_MAX_C}, got C={c}')


def lift_splat(depth: torch.Tensor, ctx: torch.Tensor, flat_idx: torch.Tensor,
               n_cells: int) -> torch.Tensor:
    """The raw-rig splat of every camera.

    Args:
      depth: [M, D, P] depth distributions (or the one-hot oracle), any strides.
      ctx: [M, P, C] context features of depth's dtype, any strides.
      flat_idx: [M, D, P] int32 BEV cell of each (bin, pixel) in [0, n_cells]
        (n_cells = off the grid).
      n_cells: ny * nx.

    Returns [M, n_cells, C] in ctx's dtype. A CPU tensor takes
    :func:`lift_splat_plain`; a CUDA tensor launches kernel K8 (one launch,
    no float atomics, each output cell written once; C a multiple of 8 up
    to ``RAW_MAX_C``) or raises. A CUDA call that needs a gradient goes
    through :class:`LiftSplatRaw`, whose backward is kernel K8'."""
    _check_raw(depth, ctx, flat_idx)
    if depth.device.type == 'cpu':
        return lift_splat_plain(depth, ctx, flat_idx, n_cells)
    if torch.is_grad_enabled() and (depth.requires_grad or ctx.requires_grad):
        return LiftSplatRaw.apply(depth, ctx, flat_idx, n_cells)
    return _splat_raw(depth, ctx, flat_idx, n_cells)


lift_splat.launches = 0


def raw_splat_atomic_adds(depth: torch.Tensor, ctx: torch.Tensor, flat_idx: torch.Tensor,
                          n_cells: int) -> dict:
    """Launch kernel K8 as :func:`lift_splat` does, on CUDA tensors, and
    read the counts it keeps on the card: the kept rows it scattered and
    the integer atomics of its count, scatter and combine phases. K8 has no
    float atomic to count; ``build.float_atomics('lift_splat_raw',
    'lift_splat_raw_kernel')`` reads its SASS for them."""
    if depth.device.type != 'cuda':
        raise ValueError('raw_splat_atomic_adds: kernel K8 counts its adds on a CUDA device')
    _check_raw(depth, ctx, flat_idx)
    adds = torch.zeros(4, dtype=torch.int64, device=depth.device)
    _splat_raw(depth, ctx, flat_idx, n_cells, adds)
    return dict(zip(('kept_rows', 'count_int_atomics', 'scatter_int_atomics',
                     'combine_int_atomics'), adds.tolist()))


def _aligned_rows(t: torch.Tensor) -> bool:
    """8-channel rows of ``t`` [..., C] load as one aligned vector."""
    row = 8 * t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % row == 0
            and all(st * t.element_size() % row == 0 for st in t.stride()[:-1]))


def _splat_raw(depth, ctx, flat_idx, n_cells, adds=None):
    """One launch of kernel K8 on CUDA tensors."""
    m, d, p = depth.shape
    c = ctx.shape[-1]
    out = torch.empty(m, n_cells, c, dtype=ctx.dtype, device=depth.device)
    if out.numel() == 0:
        return out
    flat_idx = flat_idx.contiguous()   # the path's indices are: no copy there
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    # the barrier's two words and the cell counts: zero, and left so
    _, words = build.scratch('lift_splat_raw', depth.device, stream, 0, 2 + m * n_cells)
    lib = _lib_raw()
    work = torch.empty(lib.lift_splat_raw_workspace(m, d, p, c, n_cells, RAW_CHUNK,
                                                    ctx.element_size()),
                       dtype=torch.uint8, device=depth.device)
    with torch.cuda.device(depth.device):
        code = lib.lift_splat_raw(_DTYPES[depth.dtype], depth.data_ptr(), *depth.stride(),
                                  ctx.data_ptr(), *ctx.stride(), int(_aligned_rows(ctx)),
                                  flat_idx.data_ptr(), m, d, p, c, n_cells, RAW_CHUNK,
                                  words.data_ptr(), work.data_ptr(), out.data_ptr(),
                                  None if adds is None else adds.data_ptr(), stream)
    build.check(lib, code, 'lift_splat')
    lift_splat.launches += 1
    return out


def lift_splat_backward_plain(g: torch.Tensor, depth: torch.Tensor, ctx: torch.Tensor,
                              flat_idx: torch.Tensor, n_cells: int):
    """Plain PyTorch version of :func:`lift_splat_backward`: autograd
    through :func:`lift_splat_plain`."""
    with torch.enable_grad():
        dep = depth.detach().requires_grad_()
        cx = ctx.detach().requires_grad_()
        out = lift_splat_plain(dep, cx, flat_idx, n_cells)
        d_depth, d_ctx = torch.autograd.grad(out, (dep, cx), g)
    return d_depth, d_ctx


def lift_splat_backward(g: torch.Tensor, depth: torch.Tensor, ctx: torch.Tensor,
                        flat_idx: torch.Tensor, n_cells: int):
    """Gradients (d depth, d ctx) of :func:`lift_splat` for the output
    gradient ``g`` [M, n_cells, C] (ctx's dtype, any strides), in depth's
    and ctx's dtypes:

        G[m, d, p] = g[m, idx[m, d, p]]  (zero for the trash cell)
        d depth[m, d, p] = sum_c ctx[m, p, c] G[m, d, p, c]
        d ctx[m, p, c]   = sum_d depth[m, d, p] G[m, d, p, c]

    each product rounded to the inputs' dtype, as autograd through the plain
    version rounds it. A CPU tensor takes :func:`lift_splat_backward_plain`;
    a CUDA tensor launches kernel K8' once (a block a tile of 32 pixels, row
    gathers, float32 sums in a fixed order, each output written once, no
    atomics) or raises."""
    _check_raw(depth, ctx, flat_idx, 'lift_splat_backward')
    m, d, p = depth.shape
    c = ctx.shape[-1]
    if g.shape != (m, n_cells, c) or g.dtype != ctx.dtype or g.device != depth.device:
        raise ValueError(f'lift_splat_backward: g [M, n_cells, C] = {(m, n_cells, c)} of '
                         f'ctx\'s dtype and device, got {tuple(g.shape)} {g.dtype} on '
                         f'{g.device}')
    if depth.device.type == 'cpu':
        return lift_splat_backward_plain(g, depth, ctx, flat_idx, n_cells)
    d_depth, d_ctx = torch.empty_like(depth), torch.empty_like(ctx)
    flat_idx = flat_idx.contiguous()
    if g.stride(2) != 1:
        g = g.contiguous()
    g_vec = int(_aligned_rows(g))   # g's 8-channel rows by vector loads
    lib = _lib_raw()
    with torch.cuda.device(depth.device):
        code = lib.lift_splat_raw_backward(
            _DTYPES[depth.dtype], g.data_ptr(), *g.stride()[:2], g_vec, depth.data_ptr(),
            *depth.stride(), ctx.data_ptr(), *ctx.stride(), flat_idx.data_ptr(),
            d_depth.data_ptr(), *d_depth.stride(), d_ctx.data_ptr(), *d_ctx.stride(), m, d, p,
            c, n_cells, torch.cuda.current_stream(depth.device).cuda_stream)
    build.check(lib, code, 'lift_splat_backward')
    lift_splat_backward.launches += 1
    return d_depth, d_ctx


lift_splat_backward.launches = 0


class LiftSplatRaw(torch.autograd.Function):
    """:func:`lift_splat` with a gradient on the card: the forward is kernel
    K8, the backward :func:`lift_splat_backward` (kernel K8'). The indices
    are data: no gradient.

    ``LiftSplatRaw.apply(depth, ctx, flat_idx, n_cells)``."""

    @staticmethod
    def forward(fctx, depth, ctx, flat_idx, n_cells):
        fctx.n_cells = n_cells
        fctx.save_for_backward(depth, ctx, flat_idx)
        return _splat_raw(depth, ctx, flat_idx, n_cells)

    @staticmethod
    def backward(fctx, g):
        depth, ctx, flat_idx = fctx.saved_tensors
        d_depth, d_ctx = lift_splat_backward(g, depth, ctx, flat_idx, fctx.n_cells)
        return d_depth, d_ctx, None, None
