"""Plain PyTorch versions of ``affine_act``: a frozen copy of the port's plain
functions, with each public name bound to its plain version."""
from __future__ import annotations
from typing import Optional
import torch


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


def affine_act_masked_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                            mask: torch.Tensor,
                            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`affine_act_masked`."""
    return affine_act_plain(x, scale, shift, residual, True, mask)


affine_act = affine_act_plain
affine_act_masked = affine_act_masked_plain
