"""BatchNorm applied through kernel A, in eval and in train mode.

The port of ``mm_training_tpu/models/bn_fold.py::batch_norm`` (flax
``nn.BatchNorm``, momentum 0.9, eps 1e-5) on its unfolded path. Either mode
is the per-channel affine ``y = x * s + t`` applied by kernel A together with
the ReLU and, in a BasicBlock, the residual add that follow it:

* eval: ``s = weight / sqrt(running_var + eps)``, ``t = bias - running_mean
  * s`` from the frozen statistics, in float32;
* train: the same with the batch's float32 mean and biased variance over
  (N, H, W), computed with torch ops so that autograd carries their
  gradient, and the running statistics updated as flax does,
  ``0.9 * old + 0.1 * batch`` (no ``num_batches_tracked``, the biased
  variance).

With gradients on, the affine goes through :class:`~mm_training_tpu_torch.
ops.affine_act.AffineAct` (kernel A forward, kernel A' backward). Folding BN
into the conv weights (``fold_conv_bn``) arrives with the checkpoint-import
slice.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import affine_act

__all__ = ['BatchNorm2d', 'StateCache', 'begin_step']


class StateCache:
    """A value made from some tensors, kept until one of them changes: its
    object, its storage or its in-place version (an optimizer step, a
    state-dict load, a dtype cast), or the ``extra`` key. The key holds the
    tensors themselves, so a freed tensor's memory reused by a new one
    cannot pass for it."""

    def __init__(self):
        self.key = None
        self.value = None

    def get(self, tensors, extra, make):
        """``make()`` (without autograd) when the tensors or ``extra`` changed
        since the last call, else the value it made then."""
        key = [(t, t._version, t.data_ptr()) for t in tensors]
        if (self.key is None or self.key[1] != extra or len(self.key[0]) != len(key)
                or any(t is not k or v != kv or p != kp
                       for (t, v, p), (k, kv, kp) in zip(key, self.key[0]))):
            with torch.no_grad():
                self.value = make()
            self.key = (key, extra)
        return self.value


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters, buffers and state-dict names)
    whose forward is ``act(x * s + t [+ residual])`` in one kernel.

    ``relu`` is fixed per site: False for a downsample BN, True for a
    ConvBN and for a BasicBlock's second BN, whose residual add comes before
    the ReLU. ``momentum`` keeps nn.BatchNorm2d's meaning (the weight of the
    batch), so the default 0.1 is flax's momentum 0.9."""

    def __init__(self, num_features: int, relu: bool = False,
                 eps: float = 1e-5, **kw):
        super().__init__(num_features, eps=eps, **kw)
        self.relu = relu
        self._scale_shift = StateCache()
        self._first_update = True

    def scale_shift(self):
        """(s, t) float32 [C] from the (possibly bf16) parameters/stats.

        Computed once per state of the four tensors (``StateCache``), not
        per call: recomputing costs ten small launches per BN, which at batch
        1 is host time the request waits for."""
        def make():
            s = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
            return s, self.bias.float() - self.running_mean.float() * s
        return self._scale_shift.get(
            (self.weight, self.bias, self.running_mean, self.running_var), self.eps, make)

    def batch_scale_shift(self, x: torch.Tensor):
        """(s, t) [C] from the batch statistics of ``x``, in float32 (float64
        for a float64 ``x``), with autograd history; updates the running
        statistics in place.

        As in the JAX train step, whose bf16 path casts the statistics to
        bf16 once, before the step's forward, the old statistics are
        rounded to ``x``'s dtype at the first update after
        :func:`begin_step` (flax's ``0.9 * old`` then stays in that dtype);
        a later update in the same step (a camera sweep after the key frame
        runs the same BatchNorm again) takes the float32 result of the one
        before, as flax's does. The new statistics are float32."""
        if self.momentum is None or not self.track_running_stats:
            raise RuntimeError('BatchNorm2d trains with flax semantics, an exponential '
                               'running average: momentum=None or '
                               'track_running_stats=False has no counterpart')
        ct = torch.promote_types(x.dtype, torch.float32)   # flax: at least fp32
        var, mean = torch.var_mean(x.to(ct), dim=(0, 2, 3), correction=0)
        s = self.weight.to(ct) * torch.rsqrt(var + self.eps)
        t = self.bias.to(ct) - mean * s
        old_dtype = x.dtype if self._first_update else self.running_mean.dtype
        self._first_update = False
        # flax's 0.9 is a weak-typed scalar: it takes the old statistics'
        # dtype before the product (0.8984375 in bf16), torch's would not
        keep = float(torch.tensor(1.0 - self.momentum, dtype=old_dtype))
        with torch.no_grad():
            for buf, batch in ((self.running_mean, mean), (self.running_var, var)):
                buf.copy_(buf.to(old_dtype) * keep + batch * self.momentum)
        return s, t

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.contiguous(memory_format=torch.channels_last)
        if residual is not None:
            residual = residual.contiguous(memory_format=torch.channels_last)
        s, t = self.batch_scale_shift(x) if self.training else self.scale_shift()
        if torch.is_grad_enabled():
            return affine_act.AffineAct.apply(x, s, t, residual, self.relu)
        return affine_act.affine_act(x, s, t, residual, self.relu)


def begin_step(model: nn.Module) -> None:
    """Mark the start of a train step for every :class:`BatchNorm2d` of
    ``model``: the next update of its running statistics rounds the old ones
    to the compute dtype first (see :meth:`BatchNorm2d.batch_scale_shift`)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m._first_update = True
