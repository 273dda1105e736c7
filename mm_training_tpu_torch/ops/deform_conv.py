"""Kernel K5: the deformable 3x3 conv after its offset conv.

The port of ``mm_training_tpu/models/depth_net.py::DeformConv2d.__call__``
without the offset conv (:46-110): for each pixel and each of the 9 taps,
the point ``(y + ty - 1 + dy, x + tx - 1 + dx)`` is sampled bilinearly from
the NHWC map, corners outside the image weighing 0 (:56-90); the grouped
product over (tap, C/g) with fp32 sums, one rounding to the input dtype and
the bias added in that dtype follow (:100-110).

Two entries share the sampling code of ``csrc/deform_conv.cu`` (one
``__device__`` function each for the corners and the blend):

- :func:`deform_conv3x3`, the fused op on the serving path: the samples are
  built tile by tile in shared memory and contracted there on the tensor
  cores, so no column is ever written to device memory;
- :func:`deform_sample`, the columns ``[B, H*W, 9, C]``: off the serving
  path since the fused op, kept for the weight gradient of the camera
  training slice (dW = cols^T dY for each group).

Rounding follows the JAX package: coordinates and corner weights in fp32,
each weight rounded to the input dtype, then ``sampled = sampled + row *
weight`` corner by corner in the input dtype (each product and each sum
rounded), so the sampled values match the plain version bit for bit; the
fused op's fp32 sums run in another order than cuBLAS's.

There is no backward yet (serving runs under ``inference_mode``): the
training slice adds one. Until then a CUDA call that needs a gradient
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ['deform_conv3x3', 'deform_conv3x3_plain', 'deform_sample', 'deform_sample_plain',
           'halo_corners', 'pack_weight']

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
    lib.deform_conv3x3.argtypes = [i32, p, p, p, p, p, i32, i32, i32, i32, i32, i32, p, p]
    lib.deform_conv3x3.restype = ctypes.c_int
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


def pack_weight(weight: torch.Tensor, groups: int, dtype: torch.dtype) -> torch.Tensor:
    """mmcv's kernel [C_out, C_in/g, 3, 3] -> [g, 9 * C_in/g, C_out/g] in
    ``dtype``, row ``tap * C_in/g + c`` (taps row-major over the 3x3
    window): the columns' order, which the fused kernel reads."""
    o, cg = weight.shape[:2]
    g = groups
    w = weight.reshape(g, o // g, cg, 9).permute(0, 3, 2, 1).reshape(g, 9 * cg, o // g)
    return w.to(dtype).contiguous()


def deform_conv3x3_plain(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int) -> torch.Tensor:
    """Plain PyTorch version: :func:`deform_sample_plain`, the grouped
    product as one batched matrix product of the columns and the kernel in
    x's dtype, summed in fp32 (the products of bf16 values are exact there;
    no reduced-precision split reductions) and rounded once to x's dtype,
    then the bias in x's dtype. x [B, H, W, C], offsets [B, H, W, 18]
    float32, weight [g, 9 * C/g, C_out/g] (:func:`pack_weight`), bias
    [C_out] -> [B, H, W, C_out] in x's dtype."""
    b, h, w, c = x.shape
    g = groups
    cols = deform_sample_plain(x, offsets)                              # [B, HW, 9, C]
    cols = cols.reshape(b * h * w, 9, g, c // g).permute(2, 0, 1, 3).reshape(g, -1, 9 * c // g)
    out = torch.bmm(cols.float(), weight.to(x.dtype).float()).to(x.dtype)   # [g, BHW, og]
    return out.permute(1, 0, 2).reshape(b, h, w, -1) + bias.to(x.dtype)


def deform_conv3x3(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, groups: int) -> torch.Tensor:
    """The deformable 3x3 conv after its offset conv: x [B, H, W, C]
    (float32 or bfloat16, NHWC-contiguous), offsets [B, H, W, 18] float32
    (dy, dx per tap), weight [g, 9 * C/g, C_out/g] (:func:`pack_weight`)
    and bias [C_out] -> [B, H, W, C_out] in x's dtype.

    A CPU tensor takes :func:`deform_conv3x3_plain`; a CUDA tensor launches
    the fused kernel K5 once (C/g and C_out/g multiples of 8; weight and
    bias of x's dtype) or raises (also when a gradient is asked for: the
    kernel has no backward yet)."""
    return _fused(x, offsets, weight, bias, groups)


def halo_corners(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, groups: int):
    """Launch the fused kernel as :func:`deform_conv3x3` does, on CUDA
    tensors, and count on the card the bilinear corners it samples: returns
    (corners read from L2, beyond the staged halo; corners sampled)."""
    if x.device.type != 'cuda':
        raise ValueError('halo_corners: kernel K5 counts its corners on a CUDA device')
    counts = torch.zeros(2, dtype=torch.int64, device=x.device)
    _fused(x, offsets, weight, bias, groups, counts)
    from_l2, total = counts.tolist()
    return from_l2, total


def _fused(x, offsets, weight, bias, groups, counts=None):
    if x.dim() != 4 or offsets.shape != (*x.shape[:3], 18) or weight.dim() != 3:
        raise ValueError(f'deform_conv3x3: x [B, H, W, C], offsets [B, H, W, 18] and weight '
                         f'[g, 9 * C/g, C_out/g], got {tuple(x.shape)}, '
                         f'{tuple(offsets.shape)} and {tuple(weight.shape)}')
    b, h, w, c = x.shape
    g, k, og = weight.shape
    if g != groups or c % groups or k != 9 * (c // groups) or bias.shape != (g * og,):
        raise ValueError(f'deform_conv3x3: {c} channels in {groups} groups take a weight '
                         f'[{groups}, {9 * (c // max(groups, 1))}, C_out/g] and a bias '
                         f'[C_out], got {tuple(weight.shape)} and {tuple(bias.shape)}')
    if x.device.type == 'cpu':
        return deform_conv3x3_plain(x, offsets, weight, bias, groups)
    tensors = (offsets, weight, bias)
    if (x.device.type != 'cuda' or x.dtype not in _DTYPES or offsets.dtype != torch.float32
            or weight.dtype != x.dtype or bias.dtype != x.dtype
            or any(t.device != x.device for t in tensors)):
        raise ValueError(f'deform_conv3x3 takes a float32/bfloat16 CUDA or CPU x, float32 '
                         f'offsets and weight and bias of its dtype on its device, got x '
                         f'{x.dtype} on {x.device}, ' + ', '.join(
                             f'{t.dtype} on {t.device}' for t in tensors))
    if (c // groups) % 8 or og % 8:
        raise ValueError(f'deform_conv3x3: kernel K5 takes C/g and C_out/g multiples of 8, '
                         f'got {c // groups} and {og}')
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, offsets, weight, bias)):
        raise NotImplementedError('deform_conv3x3: kernel K5 has no backward yet; it '
                                  'arrives with the camera training slice (slice 4)')
    x, offsets = x.contiguous(), offsets.contiguous()
    weight, bias = weight.contiguous(), bias.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty(b, h, w, g * og, dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.deform_conv3x3(_DTYPES[x.dtype], x.data_ptr(), offsets.data_ptr(),
                                  weight.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w,
                                  c, groups, g * og,
                                  None if counts is None else counts.data_ptr(),
                                  torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, code, 'deform_conv3x3')
    deform_conv3x3.launches += 1
    return out


deform_conv3x3.launches = 0
