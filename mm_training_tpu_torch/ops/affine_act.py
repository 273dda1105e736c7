"""Kernel A: per-channel affine (+ residual) (+ ReLU), ``relu(x*s + t [+ r])``,
and its backward, kernel A'.

Replaces the TPU kernel ``scripts/bn_elementwise_probe.py::_pallas_affine``
(``pallas_call`` at :101 and :110; bodies ``_affine_relu_kernel`` and
``_affine_res_relu_kernel``): the eval-mode BatchNorm tail of every ConvBN,
BasicBlock, SECONDFPN deblock and SeparateHead branch. The CUDA source is
``csrc/affine_act.cu``; it is bound by device-memory bytes (2 or 3 x the
tensor's bytes), see the note there. Kernel A' (``csrc/affine_act_backward.cu``)
is its gradient: ``dx``, ``dr`` and the per-channel sums ``ds``, ``dt``, with
the ReLU mask recomputed exactly as the forward rounded it. :class:`AffineAct`
joins the two as a ``torch.autograd.Function``, the way every BatchNorm
reaches them when gradients are on; the JAX package has no backward kernel
here, XLA differentiates its formulation.

Tensors are NCHW in ``torch.channels_last`` memory, so the channel is the
innermost index. ``relu=False`` covers the downsample BN and the BasicBlock
``conv2`` BN whose ReLU comes after the residual add; with a ``residual`` the
add happens before the ReLU, in one pass.

The masked form (:func:`affine_act_masked`, its backward
:func:`affine_act_masked_backward`; the same two sources) is the tail of the
sparse-import LiDAR encoder (``mm_training_tpu/models/sparse_encoder.py``
:81-90, :101-111): ``relu((x*s + t) * m [+ r])`` with ``m`` one 0/1 byte a
pixel, a [N, 1, H, W] bool tensor broadcast over the channels. Each form
counts its own launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

__all__ = ['AffineAct', 'affine_act', 'affine_act_plain', 'affine_act_backward',
           'affine_act_backward_plain', 'affine_act_masked', 'affine_act_masked_plain',
           'affine_act_masked_backward', 'affine_act_masked_backward_plain']

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or float64 for float64 tensors (the plain versions only)."""
    return torch.promote_types(x.dtype, torch.float32)


def affine_act_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                     residual: Optional[torch.Tensor] = None,
                     relu: bool = True, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: fp32 arithmetic (float64 for float64 inputs),
    one rounding to ``x.dtype``. ``x`` [N, C, H, W]; ``scale``, ``shift``
    [C] float32; ``mask`` [N, 1, H, W] bool multiplies ``x*s + t`` before the
    residual."""
    c = x.shape[1]
    ct = _compute_dtype(x)
    y = x.to(ct) * scale.view(1, c, 1, 1)
    y = y + shift.view(1, c, 1, 1)
    if mask is not None:
        y = y * mask.to(ct)
    if residual is not None:
        y = y + residual.to(ct)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load('affine_act')
    p = ctypes.c_void_p
    lib.affine_act.argtypes = [ctypes.c_int, p, p, p, p, p, p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int, p]
    lib.affine_act.restype = ctypes.c_int
    return lib


def _check_mask(mask: torch.Tensor, x: torch.Tensor, what: str) -> None:
    n, _, h, w = x.shape
    if (mask.shape != (n, 1, h, w) or mask.dtype != torch.bool or mask.device != x.device
            or not mask.is_contiguous()):
        raise ValueError(f'{what}: mask must be a contiguous bool [{n}, 1, {h}, {w}] tensor on '
                         f'{x.device}, got {tuple(mask.shape)} {mask.dtype} {mask.device}')


def _check_operand(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f'affine_act: {name} {tuple(t.shape)} {t.dtype} {t.device} '
                         f'does not match x {tuple(like.shape)} {like.dtype} {like.device}')
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f'affine_act: {name} must be channels_last-contiguous')
    if t.data_ptr() % 16:
        raise ValueError(f'affine_act: {name} must be 16-byte aligned')


def _forward(x, scale, shift, residual, relu, mask, what):
    """One launch of kernel A (masked when ``mask`` is given) on CUDA
    tensors, checked first; counts nothing."""
    if x.device.type != 'cuda' or x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f'{what} takes a 4-D float32/bfloat16 CUDA or CPU '
                         f'tensor, got {tuple(x.shape)} {x.dtype} on {x.device}')
    c = x.shape[1]
    _check_operand('x', x, x)
    if residual is not None:
        _check_operand('residual', residual, x)
    if mask is not None:
        _check_mask(mask, x, what)
    for name, v in (('scale', scale), ('shift', shift)):
        if (v.shape != (c,) or v.dtype != torch.float32 or v.device != x.device
                or not v.is_contiguous()):
            raise ValueError(f'{what}: {name} must be a contiguous float32 [{c}] '
                             f'tensor on {x.device}')
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.affine_act(
            _DTYPES[x.dtype], x.data_ptr(),
            None if residual is None else residual.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), x.numel(), c, int(relu),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, code, what)
    return out


def affine_act(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               residual: Optional[torch.Tensor] = None,
               relu: bool = True) -> torch.Tensor:
    """``relu(x * scale + shift [+ residual])`` per channel.

    A CPU tensor takes :func:`affine_act_plain`; a CUDA tensor launches the
    kernel (``x`` float32 or bfloat16, channels_last, 16-byte aligned) or
    raises."""
    if x.device.type == 'cpu':
        return affine_act_plain(x, scale, shift, residual, relu)
    out = _forward(x, scale, shift, residual, relu, None, 'affine_act')
    affine_act.launches += 1
    return out


affine_act.launches = 0


def affine_act_masked_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                            mask: torch.Tensor,
                            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`affine_act_masked`."""
    return affine_act_plain(x, scale, shift, residual, True, mask)


def affine_act_masked(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                      mask: torch.Tensor,
                      residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu((x * scale + shift) * mask [+ residual])``: ``mask`` [N, 1, H,
    W] bool, one byte a pixel, multiplied in (not selected: a NaN stays
    NaN), before the residual.

    A CPU tensor takes :func:`affine_act_masked_plain`; a CUDA tensor
    launches kernel A's masked form (operands as :func:`affine_act` takes
    them, the mask contiguous) or raises."""
    if x.device.type == 'cpu':
        return affine_act_masked_plain(x, scale, shift, mask, residual)
    out = _forward(x, scale, shift, residual, True, mask, 'affine_act_masked')
    affine_act_masked.launches += 1
    return out


affine_act_masked.launches = 0


def affine_act_backward_plain(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                              shift: torch.Tensor, residual: Optional[torch.Tensor] = None,
                              relu: bool = True, mask: Optional[torch.Tensor] = None):
    """Plain PyTorch backward of :func:`affine_act_plain` for the output
    gradient ``g``: (dx in x's dtype, dr in x's dtype or None, ds, dt [C] in
    the compute dtype). The ReLU mask is ``z > 0`` with ``z`` rounded as the
    forward's; with ``mask`` the gradient past the residual add is taken
    times the mask."""
    c = x.shape[1]
    ct = _compute_dtype(x)
    xf = x.to(ct)
    m = g.to(ct)
    k = None if mask is None else mask.to(ct)
    if relu:
        z = xf * scale.view(1, c, 1, 1)
        z = z + shift.view(1, c, 1, 1)
        if k is not None:
            z = z * k
        if residual is not None:
            z = z + residual.to(ct)
        m = torch.where(z > 0, m, 0.0)
    dr = None if residual is None else m.to(x.dtype)
    if k is not None:
        m = m * k
    dx = (m * scale.view(1, c, 1, 1)).to(x.dtype)
    return dx, dr, (m * xf).sum((0, 2, 3)), m.sum((0, 2, 3))


@functools.lru_cache(maxsize=None)
def _lib_backward() -> ctypes.CDLL:
    lib = build.load('affine_act_backward')
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.affine_act_backward.argtypes = [i32, p, p, p, p, p, p, p, p, p, p, p, i64, p, i64,
                                        i32, i32, i32, p]
    lib.affine_act_backward.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _partials_floats(device: int) -> int:
    """Float32 partials kernel A' may write on this card at any shape: 8
    values for each thread the SMs hold (csrc/affine_act_backward.cu says
    why)."""
    props = torch.cuda.get_device_properties(device)
    return 8 * props.max_threads_per_multi_processor * props.multi_processor_count


def _backward(g, x, scale, shift, residual, relu, mask, what):
    """One launch of kernel A' (masked when ``mask`` is given) on CUDA
    tensors, checked first; counts nothing."""
    if x.device.type != 'cuda' or x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f'{what} takes a 4-D float32/bfloat16 CUDA or '
                         f'CPU tensor, got {tuple(x.shape)} {x.dtype} on {x.device}')
    c = x.shape[1]
    _check_operand('x', x, x)
    _check_operand('g', g, x)
    if residual is not None:
        _check_operand('residual', residual, x)
    if mask is not None:
        _check_mask(mask, x, what)
    for name, v in (('scale', scale), ('shift', shift)):
        if (v.shape != (c,) or v.dtype != torch.float32 or v.device != x.device
                or not v.is_contiguous()):
            raise ValueError(f'{what}: {name} must be a contiguous float32 '
                             f'[{c}] tensor on {x.device}')
    dx = torch.empty_like(x)
    dr = None if residual is None else torch.empty_like(x)
    sums = torch.empty(2, c, dtype=torch.float32, device=x.device)
    lib = _lib_backward()
    npix = x.numel() // c if c else 0
    dtype = _DTYPES[x.dtype]
    vector = int(c % (16 // x.element_size()) == 0)   # operands are 16-byte aligned
    stream = torch.cuda.current_stream(x.device).cuda_stream
    part, barrier = build.scratch('affine_act_backward', x.device, stream,
                                  _partials_floats(x.device.index), 2)
    with torch.cuda.device(x.device):
        code = lib.affine_act_backward(
            dtype, g.data_ptr(), x.data_ptr(),
            None if residual is None else residual.data_ptr(),
            None if mask is None else mask.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), dx.data_ptr(),
            None if dr is None else dr.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
            part.data_ptr(), part.numel(), barrier.data_ptr(), npix, c, int(relu), vector,
            stream)
    build.check(lib, code, what)
    return dx, dr, sums[0], sums[1]


def affine_act_backward(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, residual: Optional[torch.Tensor] = None,
                        relu: bool = True):
    """Gradients of ``relu(x * scale + shift [+ residual])`` for the output
    gradient ``g``: (dx, dr or None, ds, dt), ``ds``/``dt`` float32 [C].

    A CPU tensor takes :func:`affine_act_backward_plain`; a CUDA tensor
    launches kernel A' (operands as :func:`affine_act` takes them, ``g`` of
    x's shape and dtype, channels_last, any C) or raises. One launch a call;
    the per-channel sums are deterministic (fixed-order partials), and the
    scratch they pass through is kept per device and stream."""
    if x.device.type == 'cpu':
        return affine_act_backward_plain(g, x, scale, shift, residual, relu)
    out = _backward(g, x, scale, shift, residual, relu, None, 'affine_act_backward')
    affine_act_backward.launches += 1
    return out


affine_act_backward.launches = 0


def affine_act_masked_backward_plain(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                                     shift: torch.Tensor, mask: torch.Tensor,
                                     residual: Optional[torch.Tensor] = None):
    """Plain PyTorch version of :func:`affine_act_masked_backward`."""
    return affine_act_backward_plain(g, x, scale, shift, residual, True, mask)


def affine_act_masked_backward(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                               shift: torch.Tensor, mask: torch.Tensor,
                               residual: Optional[torch.Tensor] = None):
    """Gradients of :func:`affine_act_masked` for the output gradient ``g``:
    (dx, dr or None, ds, dt). With ``z = (x*s + t) * mask [+ r]`` and
    ``m = g * [z > 0]``: ``dr = m``, and ``dx``, ``ds``, ``dt`` as
    :func:`affine_act_backward` computes them from ``m * mask``.

    A CPU tensor takes :func:`affine_act_masked_backward_plain`; a CUDA
    tensor launches kernel A''s masked form, one launch a call, or raises."""
    if x.device.type == 'cpu':
        return affine_act_masked_backward_plain(g, x, scale, shift, mask, residual)
    out = _backward(g, x, scale, shift, residual, True, mask, 'affine_act_masked_backward')
    affine_act_masked_backward.launches += 1
    return out


affine_act_masked_backward.launches = 0


class AffineAct(torch.autograd.Function):
    """``relu(x * scale + shift [+ residual])`` with a gradient: the forward
    is :func:`affine_act` (kernel A on the card), the backward
    :func:`affine_act_backward` (kernel A'). ``scale`` and ``shift`` may
    carry autograd history (a train-mode BatchNorm's batch statistics): their
    gradients are the per-channel sums ``ds`` and ``dt``. With a ``mask``
    (a non-differentiable input) the masked forms run instead
    (:func:`affine_act_masked`, :func:`affine_act_masked_backward`).

    ``AffineAct.apply(x, scale, shift, residual, relu, mask=None)``."""

    @staticmethod
    def forward(ctx, x, scale, shift, residual, relu, mask=None):
        ctx.relu = relu
        ctx.save_for_backward(x, scale, shift, residual, mask)
        if mask is not None:
            return affine_act_masked(x, scale, shift, mask, residual)
        return affine_act(x, scale, shift, residual, relu)

    @staticmethod
    def backward(ctx, g):
        x, scale, shift, residual, mask = ctx.saved_tensors
        g = g.contiguous(memory_format=torch.channels_last)
        if mask is not None:
            dx, dr, ds, dt = affine_act_masked_backward(g, x, scale, shift, mask, residual)
        else:
            dx, dr, ds, dt = affine_act_backward(g, x, scale, shift, residual, ctx.relu)
        return dx, ds, dt, dr, None, None
