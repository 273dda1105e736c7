"""BatchNorm as the per-channel affine ``y = x * s + t`` (+ residual, + ReLU),
in eval and in train mode, flax's momentum 0.9 and eps 1e-5: a frozen
copy of the port's ``models/bn_fold.py`` on its plain path (the affine in
plain PyTorch, differentiated by autograd; one process)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel
from ..ops import affine_act

__all__ = ['BatchNorm2d', 'StateCache', 'begin_step', 'group_moments']


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


def group_moments(n: torch.Tensor, mean: torch.Tensor, m2: torch.Tensor):
    """(mean, biased variance) [C] of the global batch from this rank's
    count ``n`` [1], mean [C] and sum of squared deviations from it ``m2``
    [C]: the ranks' rows meet in one all-reduce (each rank fills its own row
    of a [world, 2C+1] matrix of zeros), and every rank combines them in
    rank order as Chan et al.'s parallel variance, ``sum(m2_r + n_r (mean_r
    - mean)^2) / sum(n_r)``, which adds no cancellation to the ranks' own
    two-pass moments. Differentiable: the backward is the same all-reduce,
    so each rank's input gradient sees the global statistics' gradient. A
    global count of 0 gives NaN, as flax's masked mean does.

    On a model axis (``parallel/spatial.py``) the rows are the world's: a
    head pixel lies in one W shard, so it counts once; the encoders run
    alike on the model peers, so their counts and sums both scale by
    ``model_parallel``, which leaves the statistics and (each peer adding
    its share of the backward) the gradients those of the data ranks'
    rows (``tests/test_torch_model_parallel.py`` holds both to one
    process)."""
    world, rank = parallel.process_count(), parallel.process_index()
    row = torch.cat([n, mean, m2])
    rows = parallel.all_reduce_sum(F.pad(row[None], (0, 0, rank, world - 1 - rank)))
    ch = mean.shape[0]
    ns, means, m2s = rows[:, :1], rows[:, 1:ch + 1], rows[:, ch + 1:]
    total = ns.sum(0)
    global_mean = (ns * means).sum(0) / total
    return global_mean, (m2s + ns * (means - global_mean) ** 2).sum(0) / total


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

    def batch_statistics(self, x: torch.Tensor, ct: torch.dtype):
        """(mean, biased variance) [C] of ``x`` over (N, H, W) in ``ct``; in
        a process group over every rank's rows (:func:`group_moments`)."""
        var, mean = torch.var_mean(x.to(ct), dim=(0, 2, 3), correction=0)
        if not parallel.active():
            return mean, var
        n = mean.new_full((1,), x.numel() // x.shape[1])
        return group_moments(n, mean, var * n)

    def batch_scale_shift(self, x: torch.Tensor, *stats_args):
        """(s, t) [C] from the batch statistics of ``x`` (and ``stats_args``,
        what :meth:`batch_statistics` takes besides), in float32 (float64
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
        mean, var = self.batch_statistics(x, ct, *stats_args)
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
        return affine_act.affine_act(x, s, t, residual, self.relu)


def begin_step(model: nn.Module) -> None:
    """Mark the start of a train step for every :class:`BatchNorm2d` of
    ``model``: the next update of its running statistics rounds the old ones
    to the compute dtype first (see :meth:`BatchNorm2d.batch_scale_shift`)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m._first_update = True
