"""Eval-mode BatchNorm applied through kernel A.

The port of ``mm_training_tpu/models/bn_fold.py::batch_norm`` on its unfolded
eval path: with frozen running statistics a BatchNorm is the per-channel
affine ``y = x * s + t``, ``s = weight / sqrt(running_var + eps)``,
``t = bias - running_mean * s``, computed here in float32 and applied by
:func:`mm_training_tpu_torch.ops.affine_act.affine_act` together with the
ReLU and, in a BasicBlock, the residual add that follow it. Folding BN into
the conv weights (``fold_conv_bn``) arrives with the checkpoint-import slice.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import affine_act

__all__ = ['BatchNorm2d']


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters, buffers and state-dict names)
    whose eval forward is ``act(x * s + t [+ residual])`` in one kernel.

    ``relu`` is fixed per site: False for a downsample BN, True for a
    ConvBN and for a BasicBlock's second BN, whose residual add comes before
    the ReLU. Training mode is refused: this slice serves only."""

    def __init__(self, num_features: int, relu: bool = False,
                 eps: float = 1e-5, **kw):
        super().__init__(num_features, eps=eps, **kw)
        self.relu = relu
        self._scale_shift = None
        self._scale_shift_key = None

    def scale_shift(self):
        """(s, t) float32 [C] from the (possibly bf16) parameters/stats.

        Computed once per state of the four tensors (storage and in-place
        version), not per call: recomputing costs ten small launches per BN,
        which at batch 1 is host time the request waits for."""
        tensors = (self.weight, self.bias, self.running_mean, self.running_var)
        key = tuple((v.data_ptr(), v._version) for v in tensors)
        if key != self._scale_shift_key:
            with torch.no_grad():
                s = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
                t = self.bias.float() - self.running_mean.float() * s
            self._scale_shift, self._scale_shift_key = (s, t), key
        return self._scale_shift

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            raise RuntimeError('BatchNorm2d of the serving slice runs in eval '
                               'mode only (call model.eval())')
        s, t = self.scale_shift()
        x = x.contiguous(memory_format=torch.channels_last)
        if residual is not None:
            residual = residual.contiguous(memory_format=torch.channels_last)
        return affine_act.affine_act(x, s, t, residual, self.relu)
