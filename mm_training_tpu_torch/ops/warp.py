"""Kernel K7: the affine BEV warp, and the image flip.

The port of ``mm_training_tpu/ops/warp.py``: ``warp_affine_nhwc`` (:56-72,
kornia's ``warp_affine``, ``dst(q) = src(inv(M) q)`` in pixel coordinates,
bilinear, zero padding), ``bda_bev_warp`` (:75-106, the BEV augmentation's
rotation, flip and scale applied to the camera BEV about its centre pixel,
the JAX package's documented deviation from the reference, which scales
about pixel (0, 0)) and ``hflip``. The CUDA source is
``csrc/bev_warp.cu``: one launch a call, which forms the pixel matrix (for
``bda_bev_warp``) and inverts it in closed form itself, so the path's warp
needs no other device op and no host-to-device copy. ``resize_bilinear``
is not ported: both BEVs sit on the grid/8 by construction, and the model
raises where they would not.

The inverse is the adjugate over the determinant, each product and sum
rounded in one fixed order, and the bilinear blend is float32 in the JAX
order (``top = v00 (1 - wx) + v01 wx``, ``bot`` alike, ``top (1 - wy) + bot
wy``), rounded once to the map's dtype, so the warp keeps a bf16 map bf16
(an fp32 result would promote the fuse layer and the head). The plain
versions take the same steps as separate torch ops, so kernel and plain
version agree bit for bit on the card. (A float64 map, in the CPU tests,
blends in float64, as the JAX package does under x64.)

The backward, kernel K7' (``bev_warp_backward`` in the same source), is the
transposed bilinear sample written as a gather: a thread owns a source
pixel and a channel vector, walks the destination pixels whose sample
point can fall in its 2 x 2 neighbourhood (the image of that square under
the forward matrix, boxed), recomputes each one's sample point with the
forward's own arithmetic, adds the forward's weight times the gradient
where it is a corner, and rounds once to the map's dtype: one launch, no
scratch, no atomics, the same bits on every call. The matrix gets no
gradient. :class:`BevWarp` joins the two as a ``torch.autograd.Function``,
which both wrappers take for a CUDA map that needs a gradient; on the CPU
autograd differentiates the plain versions.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ['BevWarp', 'bda_bev_warp', 'bda_bev_warp_plain', 'bda_pixel_matrix', 'hflip',
           'warp_affine_nhwc', 'warp_affine_nhwc_plain', 'warp_backward', 'warp_backward_plain']

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _inverse(mat: torch.Tensor) -> torch.Tensor:
    """[B, 3, 3] inverse in closed form, the kernel's order: the adjugate
    over det = (a A + b B) + c C, each product, difference and sum rounded."""
    m = mat.float()
    a, b, c, d, e, f, g, h, i = (m[:, r, k] for r in range(3) for k in range(3))
    adj = (e * i - f * h, c * h - b * i, b * f - c * e,
           f * g - d * i, a * i - c * g, c * d - a * f,
           d * h - e * g, b * g - a * h, a * e - b * d)
    det = (a * adj[0] + b * adj[3]) + c * adj[6]
    return torch.stack(adj, -1).view(-1, 3, 3) / det[:, None, None]


def _warp_plain(img: torch.Tensor, minv: torch.Tensor) -> torch.Tensor:
    b, h, w, c = img.shape
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)

    def coord(i):     # (x, y, 1) @ minv^T, left to right
        m = [minv[:, i, j, None, None] for j in range(3)]
        return (xs * m[0] + ys * m[1]) + m[2]

    p0, p1, p2 = coord(0), coord(1), coord(2)
    sx, sy = p0 / p2, p1 / p2
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = img.reshape(b, h * w, c)
    batch = torch.arange(b, device=dev)[:, None]

    ct = torch.promote_types(img.dtype, torch.float32)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        at = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, h * w)
        val = flat[batch, at].reshape(b, h, w, c)
        return torch.where(inb[..., None], val, 0.0).to(ct)

    v00, v01 = tap(x0i, y0i), tap(x0i + 1, y0i)
    v10, v11 = tap(x0i, y0i + 1), tap(x0i + 1, y0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return (top * (1 - wy) + bot * wy).to(img.dtype)


def warp_affine_nhwc_plain(img: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_affine_nhwc`."""
    return _warp_plain(img, _inverse(mat))


def bda_pixel_matrix(bda_mat: torch.Tensor, hw) -> torch.Tensor:
    """[B, 3, 3] float32 pixel transform of the BEV augmentation: the xy
    block of ``bda_mat`` ([B, 4, 4] or [B, 3, 3]) about the centre pixel
    c = ((W-1)/2, (H-1)/2), ``M = [lin | c - lin @ c]``, with
    ``t = c - (lin[:, 0] cx + lin[:, 1] cy)`` in that order (the kernel's)."""
    h, w = hw
    lin = bda_mat[:, :2, :2].float()
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    tx = cx - (lin[:, 0, 0] * cx + lin[:, 0, 1] * cy)
    ty = cy - (lin[:, 1, 0] * cx + lin[:, 1, 1] * cy)
    zero = torch.zeros_like(tx)
    return torch.stack([lin[:, 0, 0], lin[:, 0, 1], tx, lin[:, 1, 0], lin[:, 1, 1], ty,
                        zero, zero, zero + 1.0], -1).view(-1, 3, 3)


def bda_bev_warp_plain(bev: torch.Tensor, bda_mat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bda_bev_warp`."""
    return warp_affine_nhwc_plain(bev, bda_pixel_matrix(bda_mat, bev.shape[1:3]))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load('bev_warp')
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bev_warp.argtypes = [i32, p, p, i32, p, i32, i32, i32, i32, i32, p]
    lib.bev_warp.restype = ctypes.c_int
    lib.bev_warp_backward.argtypes = [i32, p, p, i32, p, i32, i32, i32, i32, i32, p]
    lib.bev_warp_backward.restype = ctypes.c_int
    return lib


def _check_cuda(img: torch.Tensor, mat: torch.Tensor, what: str) -> None:
    if img.device.type != 'cuda' or img.dtype not in _DTYPES or mat.device != img.device:
        raise ValueError(f'{what} takes a float32/bfloat16 CUDA or CPU map and a matrix on '
                         f'its device, got {img.dtype} on {img.device}, matrix on {mat.device}')
    if img.shape[0] > 65535:
        raise ValueError(f'{what}: the kernel takes B <= 65535, got {img.shape[0]}')


def _launch(img: torch.Tensor, mat: torch.Tensor, bda_n: int, what: str) -> torch.Tensor:
    """One launch of kernel K7 on a CUDA map; ``mat`` is the [B, 3, 3]
    pixel matrix (``bda_n`` 0) or the [B, n, n] BDA matrix (``bda_n`` n)."""
    _check_cuda(img, mat, what)
    img = img.contiguous()
    mat = mat.float().contiguous()
    b, h, w, c = img.shape
    out = torch.empty_like(img)
    vec = int(c % (16 // img.element_size()) == 0 and img.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(img.device):
        code = lib.bev_warp(_DTYPES[img.dtype], img.data_ptr(), mat.data_ptr(), bda_n,
                            out.data_ptr(), b, h, w, c, vec,
                            torch.cuda.current_stream(img.device).cuda_stream)
    build.check(lib, code, what)
    return out


def _check_map(img: torch.Tensor, what: str) -> None:
    if img.dim() != 4:
        raise ValueError(f'{what}: a map [B, H, W, C], got {tuple(img.shape)}')
    if not img.is_floating_point():
        raise TypeError(f'bilinear sampling needs a float map, got {img.dtype}')


def warp_affine_nhwc(img: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """``dst(q) = src(inv(M) q)``: img [B, H, W, C] float32 or bfloat16, mat
    [B, 3, 3] float32 src->dst pixel transform -> [B, H, W, C] in img's
    dtype.

    A CPU tensor takes :func:`warp_affine_nhwc_plain`; a CUDA tensor
    launches kernel K7 or raises; with a gradient, through :class:`BevWarp`
    (backward: kernel K7')."""
    _check_map(img, 'warp_affine_nhwc')
    if mat.shape != (img.shape[0], 3, 3):
        raise ValueError(f'warp_affine_nhwc: mat [B, 3, 3] for B = {img.shape[0]}, got '
                         f'{tuple(mat.shape)}')
    if img.device.type == 'cpu':
        return warp_affine_nhwc_plain(img, mat)
    if torch.is_grad_enabled() and img.requires_grad:
        return BevWarp.apply(img, mat, 0, 'warp_affine_nhwc')
    return _forward(img, mat, 0, 'warp_affine_nhwc')


warp_affine_nhwc.launches = 0


def bda_bev_warp(bev: torch.Tensor, bda_mat: torch.Tensor) -> torch.Tensor:
    """The BEV augmentation applied to a BEV map [B, H, W, C] (rotate, flip
    and scale about the centre pixel): ``bda_mat`` [B, 4, 4] or [B, 3, 3]
    float32, whose xy block is used.

    A CPU tensor takes :func:`bda_bev_warp_plain`; a CUDA tensor launches
    kernel K7 once (the pixel matrix and its inverse are formed in the
    kernel) or raises; with a gradient, through :class:`BevWarp` (backward:
    kernel K7')."""
    _check_map(bev, 'bda_bev_warp')
    n = bda_mat.shape[-1]
    if n not in (3, 4) or bda_mat.shape != (bev.shape[0], n, n):
        raise ValueError(f'bda_bev_warp: bda_mat [B, 4, 4] or [B, 3, 3] for B = '
                         f'{bev.shape[0]}, got {tuple(bda_mat.shape)}')
    if bev.device.type == 'cpu':
        return bda_bev_warp_plain(bev, bda_mat)
    if torch.is_grad_enabled() and bev.requires_grad:
        return BevWarp.apply(bev, bda_mat, n, 'bda_bev_warp')
    return _forward(bev, bda_mat, n, 'bda_bev_warp')


bda_bev_warp.launches = 0


def _forward(img: torch.Tensor, mat: torch.Tensor, bda_n: int, what: str) -> torch.Tensor:
    """The forward kernel K7 of ``what`` (its launch counted on that wrapper)."""
    out = _launch(img, mat, bda_n, what)
    (bda_bev_warp if bda_n else warp_affine_nhwc).launches += 1
    return out


def _plain(img: torch.Tensor, mat: torch.Tensor, bda_n: int) -> torch.Tensor:
    return bda_bev_warp_plain(img, mat) if bda_n else warp_affine_nhwc_plain(img, mat)


def warp_backward_plain(g: torch.Tensor, img: torch.Tensor, mat: torch.Tensor,
                        bda_n: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_backward`: autograd through
    :func:`warp_affine_nhwc_plain` (``bda_n`` 0) or
    :func:`bda_bev_warp_plain` (``bda_n`` 3 or 4)."""
    with torch.enable_grad():
        src = img.detach().requires_grad_()
        (d_src,) = torch.autograd.grad(_plain(src, mat.detach(), bda_n), (src,), g)
    return d_src


def warp_backward(g: torch.Tensor, img: torch.Tensor, mat: torch.Tensor,
                  bda_n: int = 0) -> torch.Tensor:
    """Gradient of the warp of ``img`` [B, H, W, C] for the output gradient
    ``g`` (img's shape and dtype): the transposed bilinear sample, ``d
    img[p] = sum_q w(q -> p) g[q]`` over the dst pixels q whose source point
    falls in p's 2 x 2 neighbourhood. ``mat`` and ``bda_n`` as the forward
    took them: the [B, 3, 3] pixel matrix (0, :func:`warp_affine_nhwc`) or
    the [B, n, n] BDA matrix (n, :func:`bda_bev_warp`); it gets no gradient.

    A CPU tensor takes :func:`warp_backward_plain`; a CUDA tensor launches
    kernel K7' once (a gather over each source pixel's candidate
    destination pixels, float32 sums in a fixed order rounded once to the
    map's dtype) or raises."""
    _check_map(img, 'warp_backward')
    if g.shape != img.shape or g.dtype != img.dtype or g.device != img.device:
        raise ValueError(f'warp_backward: g of the map\'s shape, dtype and device '
                         f'{tuple(img.shape)} {img.dtype} {img.device}, got {tuple(g.shape)} '
                         f'{g.dtype} {g.device}')
    if img.device.type == 'cpu':
        return warp_backward_plain(g, img, mat, bda_n)
    _check_cuda(img, mat, 'warp_backward')
    g = g.contiguous()
    mat = mat.float().contiguous()
    b, h, w, c = img.shape
    d_src = torch.empty_like(g)
    vec = int(c % (16 // img.element_size()) == 0 and g.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(img.device):
        code = lib.bev_warp_backward(_DTYPES[img.dtype], g.data_ptr(), mat.data_ptr(), bda_n,
                                     d_src.data_ptr(), b, h, w, c, vec,
                                     torch.cuda.current_stream(img.device).cuda_stream)
    build.check(lib, code, 'warp_backward')
    warp_backward.launches += 1
    return d_src


warp_backward.launches = 0


class BevWarp(torch.autograd.Function):
    """The warp with a gradient on the card: the forward is kernel K7, the
    backward :func:`warp_backward` (kernel K7'); the matrix gets none.

    ``BevWarp.apply(img, mat, bda_n, what)``: ``bda_n`` 0 for
    :func:`warp_affine_nhwc`'s pixel matrix, 3 or 4 for
    :func:`bda_bev_warp`'s BDA matrix; ``what`` names the wrapper whose
    launch count the forward adds to."""

    @staticmethod
    def forward(fctx, img, mat, bda_n, what):
        fctx.bda_n = bda_n
        fctx.save_for_backward(img, mat)
        return _forward(img, mat, bda_n, what)

    @staticmethod
    def backward(fctx, g):
        img, mat = fctx.saved_tensors
        return warp_backward(g, img, mat, fctx.bda_n), None, None, None


def hflip(img: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of [..., H, W, C]."""
    return torch.flip(img, dims=(-2,))
