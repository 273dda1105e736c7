"""Kernel A: per-channel affine (+ residual) (+ ReLU), ``relu(x*s + t [+ r])``.

Replaces the TPU kernel ``scripts/bn_elementwise_probe.py::_pallas_affine``
(``pallas_call`` at :101 and :110; bodies ``_affine_relu_kernel`` and
``_affine_res_relu_kernel``): the eval-mode BatchNorm tail of every ConvBN,
BasicBlock, SECONDFPN deblock and SeparateHead branch. The CUDA source is
``csrc/affine_act.cu``; it is bound by device-memory bytes (2 or 3 x the
tensor's bytes), see the note there.

Tensors are NCHW in ``torch.channels_last`` memory, so the channel is the
innermost index. ``relu=False`` covers the downsample BN and the BasicBlock
``conv2`` BN whose ReLU comes after the residual add; with a ``residual`` the
add happens before the ReLU, in one pass.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

__all__ = ['affine_act', 'affine_act_plain']

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def affine_act_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                     residual: Optional[torch.Tensor] = None,
                     relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version: fp32 arithmetic, one rounding to ``x.dtype``.
    ``x`` [N, C, H, W]; ``scale``, ``shift`` [C] float32."""
    c = x.shape[1]
    y = x.float() * scale.view(1, c, 1, 1)
    y = y + shift.view(1, c, 1, 1)
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load('affine_act')
    p = ctypes.c_void_p
    lib.affine_act.argtypes = [ctypes.c_int, p, p, p, p, p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int, p]
    lib.affine_act.restype = ctypes.c_int
    return lib


def _check_operand(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f'affine_act: {name} {tuple(t.shape)} {t.dtype} {t.device} '
                         f'does not match x {tuple(like.shape)} {like.dtype} {like.device}')
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f'affine_act: {name} must be channels_last-contiguous')
    if t.data_ptr() % 16:
        raise ValueError(f'affine_act: {name} must be 16-byte aligned')


def affine_act(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               residual: Optional[torch.Tensor] = None,
               relu: bool = True) -> torch.Tensor:
    """``relu(x * scale + shift [+ residual])`` per channel.

    A CPU tensor takes :func:`affine_act_plain`; a CUDA tensor launches the
    kernel (``x`` float32 or bfloat16, channels_last, 16-byte aligned) or
    raises."""
    if x.device.type == 'cpu':
        return affine_act_plain(x, scale, shift, residual, relu)
    if x.device.type != 'cuda' or x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f'affine_act takes a 4-D float32/bfloat16 CUDA or CPU '
                         f'tensor, got {tuple(x.shape)} {x.dtype} on {x.device}')
    c = x.shape[1]
    _check_operand('x', x, x)
    if residual is not None:
        _check_operand('residual', residual, x)
    for name, v in (('scale', scale), ('shift', shift)):
        if (v.shape != (c,) or v.dtype != torch.float32 or v.device != x.device
                or not v.is_contiguous()):
            raise ValueError(f'affine_act: {name} must be a contiguous float32 [{c}] '
                             f'tensor on {x.device}')
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.affine_act(
            _DTYPES[x.dtype], x.data_ptr(),
            None if residual is None else residual.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), out.data_ptr(), x.numel(), c,
            int(relu), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, code, 'affine_act')
    affine_act.launches += 1
    return out


affine_act.launches = 0
