"""Kernel K5: the bilinear sampling of the deformable 3x3 conv.

The port of the sampling half of
``mm_training_tpu/models/depth_net.py::DeformConv2d.__call__`` (:56-90):
for each pixel and each of the 9 taps, the point ``(y + ty - 1 + dy,
x + tx - 1 + dx)`` is sampled bilinearly from the NHWC map, corners outside
the image weighing 0, into the columns ``[B, H*W, 9, C]`` in the input
dtype. The grouped product with the kernel is a batched matrix product in
``models/depth_net.py``. The CUDA source is ``csrc/deform_conv.cu``; it is
bound by the bytes of the columns it writes, see the note there.

Rounding follows the JAX package: coordinates and corner weights in fp32,
each weight rounded to the input dtype, then ``sampled = sampled + row *
weight`` corner by corner in the input dtype (each product and each sum
rounded), so the kernel matches the plain version bit for bit.

There is no backward yet (serving runs under ``inference_mode``): the
training slice adds one. Until then a CUDA call that needs a gradient
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ['deform_sample', 'deform_sample_plain']

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def deform_sample_plain(x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [B, H, W, C], offsets [B, H, W, 18] float32
    (dy, dx per tap, taps row-major over the 3x3 window) -> [B, H*W, 9, C]
    in x's dtype, in the JAX package's order of operations."""
    b, h, w, c = x.shape
    nt = 9
    off = offsets.float().reshape(b, h, w, nt, 2)
    dev = x.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    k = torch.arange(3, dtype=torch.float32, device=dev) - 1
    base_dy, base_dx = torch.meshgrid(k, k, indexing='ij')
    py = ((ys[None, :, :, None] + base_dy.reshape(-1)) + off[..., 0]).reshape(b, h * w * nt)
    px = ((xs[None, :, :, None] + base_dx.reshape(-1)) + off[..., 1]).reshape(b, h * w * nt)
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    xf = x.reshape(b, h * w, c)
    batch = torch.arange(b, device=dev)[:, None]
    sampled = torch.zeros(b, h * w * nt, c, dtype=x.dtype, device=dev)
    for dy, dx, cw in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                       (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yi, xi = y0i + dy, x0i + dx
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        flat = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        rows = xf[batch, flat]                                   # [B, H*W*9, C]
        cwm = torch.where(inb, cw, 0.0).to(x.dtype)
        sampled = sampled + rows * cwm[..., None]
    return sampled.reshape(b, h * w, nt, c)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load('deform_conv')
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.deform_sample.argtypes = [i32, p, p, p, ctypes.c_longlong, i32, i32, i32, i32, p]
    lib.deform_sample.restype = ctypes.c_int
    return lib


def deform_sample(x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Bilinear columns of the deformable 3x3 conv: x [B, H, W, C] (float32
    or bfloat16, NHWC-contiguous), offsets [B, H, W, 18] float32 ->
    [B, H*W, 9, C] in x's dtype.

    A CPU tensor takes :func:`deform_sample_plain`; a CUDA tensor launches
    kernel K5 or raises (also when a gradient is asked for: the kernel has
    no backward yet)."""
    if x.dim() != 4 or offsets.shape != (*x.shape[:3], 18):
        raise ValueError(f'deform_sample: x [B, H, W, C] and offsets [B, H, W, 18], '
                         f'got {tuple(x.shape)} and {tuple(offsets.shape)}')
    if x.device.type == 'cpu':
        return deform_sample_plain(x, offsets)
    if (x.device.type != 'cuda' or x.dtype not in _DTYPES
            or offsets.device != x.device or offsets.dtype != torch.float32):
        raise ValueError(f'deform_sample takes a float32/bfloat16 CUDA or CPU x and '
                         f'float32 offsets on its device, got {x.dtype} on {x.device}, '
                         f'{offsets.dtype} on {offsets.device}')
    if torch.is_grad_enabled() and (x.requires_grad or offsets.requires_grad):
        raise NotImplementedError('deform_sample: kernel K5 has no backward yet; it '
                                  'arrives with the camera training slice (slice 4)')
    x, offsets = x.contiguous(), offsets.contiguous()
    b, h, w, c = x.shape
    cols = torch.empty(b, h * w, 9, c, dtype=x.dtype, device=x.device)
    vec = int(c % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.deform_sample(_DTYPES[x.dtype], x.data_ptr(), offsets.data_ptr(),
                                 cols.data_ptr(), b, h, w, c, vec,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, code, 'deform_sample')
    deform_sample.launches += 1
    return cols


deform_sample.launches = 0
