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
- :func:`deform_sample`, the columns ``[B, H*W, 9, C]``: on no path since
  the fused op and its fused backward, which build the same columns in
  shared memory; kept as the columns' own kernel.

Rounding follows the JAX package: coordinates and corner weights in fp32,
each weight rounded to the input dtype, then ``sampled = sampled + row *
weight`` corner by corner in the input dtype (each product and each sum
rounded), so the sampled values match the plain version bit for bit; the
fused op's fp32 sums run in another order than cuBLAS's.

The backward (:class:`DeformConv`, a ``torch.autograd.Function`` that
:func:`deform_conv3x3` takes for a CUDA call that needs a gradient) is
kernel K5', :func:`deform_conv3x3_backward`: two launches and no column
tensor. The first computes each chunk's ``d cols = dY W^T`` on the tensor
cores in shared memory, rounds it once to x's dtype (the dtype JAX's
einsum transpose gives it) and takes it through the transposed sampling
into d offsets (written once) and d x (each halo pixel's terms gathered in
registers after a counting sort of the corners, then one 16-byte atomic
add a 4-channel run into float32 sums); the second builds the columns in
shared memory the forward's way and contracts them with dY into dW
(float32 partials summed in a fixed order), with d bias. On the CPU
autograd differentiates the plain version; :func:`deform_sample_backward_plain`
is the transposed sampling alone, for a given d cols.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ['BACKWARD_MAX_GROUP_OUT', 'DeformConv', 'deform_conv3x3', 'deform_conv3x3_backward',
           'deform_conv3x3_backward_plain', 'deform_conv3x3_plain', 'deform_sample',
           'deform_sample_backward_plain', 'deform_sample_plain', 'halo_corners', 'pack_weight']

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BACKWARD_MAX_GROUP_OUT = 128   # C_out/g the backward kernels take (a dY tile a group)


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
    lib.deform_conv3x3_backward_scratch.argtypes = [i32] * 7 + [p]
    lib.deform_conv3x3_backward_scratch.restype = ctypes.c_int
    lib.deform_conv3x3_backward.argtypes = [i32] + [p] * 12 + [i32] * 6 + [p]
    lib.deform_conv3x3_backward.restype = ctypes.c_int
    return lib


def deform_sample(x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Bilinear columns of the deformable 3x3 conv: x [B, H, W, C] (float32
    or bfloat16, NHWC-contiguous), offsets [B, H, W, 18] float32 ->
    [B, H*W, 9, C] in x's dtype.

    A CPU tensor takes :func:`deform_sample_plain`; a CUDA tensor launches
    kernel K5's columns kernel or raises (also when a gradient is asked
    for: :class:`DeformConv` differentiates the conv)."""
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
        raise ValueError('deform_sample: the columns kernel takes no gradient; the conv\'s '
                         'gradient is DeformConv\'s (deform_conv3x3)')
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
    no reduced-precision split reductions; float64 inputs sum in float64)
    and rounded to float32, where the JAX package's
    ``preferred_element_type=jnp.float32`` rounds it, then once to x's
    dtype, then the bias in x's dtype. x [B, H, W, C], offsets [B, H, W, 18]
    float32, weight [g, 9 * C/g, C_out/g] (:func:`pack_weight`), bias
    [C_out] -> [B, H, W, C_out] in x's dtype."""
    b, h, w, c = x.shape
    g = groups
    ct = torch.promote_types(x.dtype, torch.float32)
    cols = deform_sample_plain(x, offsets)                              # [B, HW, 9, C]
    cols = cols.reshape(b * h * w, 9, g, c // g).permute(2, 0, 1, 3).reshape(g, -1, 9 * c // g)
    out = torch.bmm(cols.to(ct), weight.to(x.dtype).to(ct)).float().to(x.dtype)  # [g, BHW, og]
    return out.permute(1, 0, 2).reshape(b, h, w, -1) + bias.to(x.dtype)


def deform_conv3x3(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, groups: int) -> torch.Tensor:
    """The deformable 3x3 conv after its offset conv: x [B, H, W, C]
    (float32 or bfloat16, NHWC-contiguous), offsets [B, H, W, 18] float32
    (dy, dx per tap), weight [g, 9 * C/g, C_out/g] (:func:`pack_weight`)
    and bias [C_out] -> [B, H, W, C_out] in x's dtype.

    A CPU tensor takes :func:`deform_conv3x3_plain`; a CUDA tensor launches
    the fused kernel K5 once (C/g and C_out/g multiples of 8; weight and
    bias of x's dtype) or raises. A CUDA call that needs a gradient goes
    through :class:`DeformConv` (backward: :func:`deform_conv3x3_backward`)."""
    _check(x, offsets, weight, bias, groups)
    if x.device.type == 'cpu':
        return deform_conv3x3_plain(x, offsets, weight, bias, groups)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, offsets, weight, bias)):
        return DeformConv.apply(x, offsets, weight, bias, groups)
    return _fused(x, offsets, weight, bias, groups)


def halo_corners(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, groups: int):
    """Launch the fused kernel as :func:`deform_conv3x3` does, on CUDA
    tensors, and count on the card the bilinear corners it samples: returns
    (corners read from L2, beyond the staged halo; corners sampled)."""
    if x.device.type != 'cuda':
        raise ValueError('halo_corners: kernel K5 counts its corners on a CUDA device')
    _check(x, offsets, weight, bias, groups)
    counts = torch.zeros(2, dtype=torch.int64, device=x.device)
    _fused(x, offsets, weight, bias, groups, counts)
    from_l2, total = counts.tolist()
    return from_l2, total


def _check(x, offsets, weight, bias, groups):
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


def _check_cuda(x, offsets, weight, bias, groups):
    og = weight.shape[2]
    c = x.shape[3]
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


def _fused(x, offsets, weight, bias, groups, counts=None):
    """One launch of the fused kernel K5 on CUDA tensors."""
    _check_cuda(x, offsets, weight, bias, groups)
    b, h, w, c = x.shape
    g, _, og = weight.shape
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


def deform_sample_backward_plain(dcols: torch.Tensor, x: torch.Tensor, offsets: torch.Tensor,
                                 groups: int):
    """Gradients (d x, d offsets) of the columns :func:`deform_sample_plain`
    for their gradient laid out as the grouped product leaves it, ``dcols``
    [g, B*H*W, 9 * C/g] (row ``tap * C/g + c``): autograd through
    :func:`deform_sample_plain`. d x takes each corner's weight where it is
    inside the image; d offsets the corner differences (floor without a
    gradient, as in JAX: at a whole pixel the one-sided difference). K5''s d
    x and d offsets are held to it (``exps/backward_checks.py``)."""
    b, h, w, c = x.shape
    g = groups
    d = dcols.reshape(g, b * h * w, 9, c // g).permute(1, 2, 0, 3).reshape(b, h * w, 9, c)
    with torch.enable_grad():
        xs = x.detach().requires_grad_()
        off = offsets.detach().requires_grad_()
        dx, doff = torch.autograd.grad(deform_sample_plain(xs, off), (xs, off), d)
    return dx, doff


def deform_conv3x3_backward_plain(dy: torch.Tensor, x: torch.Tensor, offsets: torch.Tensor,
                                  weight: torch.Tensor, bias: torch.Tensor, groups: int):
    """Plain PyTorch version of :func:`deform_conv3x3_backward`: autograd
    through :func:`deform_conv3x3_plain`."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, offsets, weight, bias)]
        out = deform_conv3x3_plain(*ins, groups)
        return torch.autograd.grad(out, ins, dy)


def deform_conv3x3_backward(dy: torch.Tensor, x: torch.Tensor, offsets: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor, groups: int):
    """Gradients (d x, d offsets, d weight, d bias) of :func:`deform_conv3x3`
    for the output gradient ``dy`` [B, H, W, C_out] (x's dtype), each in its
    input's dtype and layout ([g, 9 * C/g, C_out/g] for the weight).

    A CPU tensor takes :func:`deform_conv3x3_backward_plain`. A CUDA tensor
    launches kernel K5' (C/g and C_out/g multiples of 8, C_out/g up to
    :data:`BACKWARD_MAX_GROUP_OUT`; else it raises): two device ops, no
    column tensor, no ``torch.bmm``. d x's float32 sums meet by atomics (no
    fixed order); d offsets, d weight and d bias are summed in a fixed
    order, the same bits on every call. See ``csrc/deform_conv.cu``."""
    _check(x, offsets, weight, bias, groups)
    b, h, w, c = x.shape
    g, _, og = weight.shape
    if dy.shape != (b, h, w, g * og):
        raise ValueError(f'deform_conv3x3_backward: dy [B, H, W, C_out] = '
                         f'{(b, h, w, g * og)}, got {tuple(dy.shape)}')
    if x.device.type == 'cpu':
        return deform_conv3x3_backward_plain(dy, x, offsets, weight, bias, groups)
    _check_backward(x, offsets, weight, bias, groups)
    if dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f'deform_conv3x3_backward: dy of x\'s dtype and device '
                         f'({x.dtype} on {x.device}), got {dy.dtype} on {dy.device}')
    if b * h * w == 0:
        return (torch.zeros_like(x), torch.zeros_like(offsets), torch.zeros_like(weight),
                torch.zeros_like(bias))
    x, dy = _aligned(x), _aligned(dy)
    offsets, weight = offsets.contiguous(), _aligned(weight)
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    dtype = _DTYPES[x.dtype]
    sizes = (ctypes.c_longlong * 2)()
    with torch.cuda.device(dev):
        code = lib.deform_conv3x3_backward_scratch(dtype, b, h, w, c, g, g * og,
                                                   ctypes.cast(sizes, ctypes.c_void_p))
    build.check(lib, code, 'deform_conv3x3_backward')
    partials, counters = build.scratch('deform_conv3x3_backward_weight', dev, stream, sizes[0],
                                       sizes[1])
    d_x = torch.empty_like(x)
    sums, barrier = build.scratch('deform_conv3x3_backward_input', dev, stream,
                                  0 if x.dtype == torch.float32 else x.numel(), 2)
    if x.dtype == torch.float32:
        sums = d_x
    d_off, d_weight = torch.empty_like(offsets), torch.empty_like(weight)
    d_bias = torch.empty(bias.shape, dtype=bias.dtype, device=dev)
    with torch.cuda.device(dev):
        code = lib.deform_conv3x3_backward(
            dtype, x.data_ptr(), offsets.data_ptr(), weight.data_ptr(), dy.data_ptr(),
            sums.data_ptr(), None if x.dtype == torch.float32 else d_x.data_ptr(),
            d_off.data_ptr(), d_weight.data_ptr(), d_bias.data_ptr(), barrier.data_ptr(),
            partials.data_ptr(), counters.data_ptr(), b, h, w, c, g, g * og, stream)
    build.check(lib, code, 'deform_conv3x3_backward')
    deform_conv3x3_backward.launches += 1
    return d_x, d_off, d_weight, d_bias


deform_conv3x3_backward.launches = 0


def _check_backward(x, offsets, weight, bias, groups):
    """What kernel K5' takes on top of the fused forward's limits."""
    _check_cuda(x, offsets, weight, bias, groups)
    if weight.shape[2] > BACKWARD_MAX_GROUP_OUT:
        raise ValueError(f'deform_conv3x3_backward: kernel K5\' takes C_out/g up to '
                         f'{BACKWARD_MAX_GROUP_OUT}, got {weight.shape[2]}')


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a copy only where it is not)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class DeformConv(torch.autograd.Function):
    """:func:`deform_conv3x3` with a gradient on the card: the forward is
    the fused kernel K5, the backward kernel K5'
    (:func:`deform_conv3x3_backward`); shapes the backward does not take
    raise before the forward runs.

    ``DeformConv.apply(x, offsets, weight, bias, groups)``."""

    @staticmethod
    def forward(fctx, x, offsets, weight, bias, groups):
        _check_backward(x, offsets, weight, bias, groups)
        fctx.groups = groups
        fctx.save_for_backward(x, offsets, weight, bias)
        return _fused(x, offsets, weight, bias, groups)

    @staticmethod
    def backward(fctx, dy):
        x, offsets, weight, bias = fctx.saved_tensors
        grads = deform_conv3x3_backward(dy, x, offsets, weight, bias, fctx.groups)
        return (*grads, None)
