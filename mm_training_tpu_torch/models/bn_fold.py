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
  variance). In a process group the statistics are those of the global
  batch, every rank's rows (:func:`group_moments`).

With gradients on, the affine goes through :class:`~mm_training_tpu_torch.
ops.affine_act.AffineAct` (kernel A forward, kernel A' backward).

:class:`MaskedBatchNorm2d` is the sparse-import encoder's BN (the JAX
``ImportSparseEncoder``'s ``nn.BatchNorm(mask=...)``, eps 1e-3, flax
momentum 0.99): statistics over the active pixels of a [N, 1, H, W] mask
only, and a tail ``relu((x*s + t) * mask [+ residual])`` through kernel A's
masked form. It does not fold (JAX ``test_bn_fold.py::
test_sparse_encoder_stats_pass_through``): :func:`conv_bn_pairs` skips it.

Deploy-time folding (the mmcv ``fuse_conv_bn`` equivalent; the port of
``fold_conv_bn``/``fold_state``, JAX :101-212): an eval BN is ``x * s + t``
with ``s = weight / sqrt(var + eps)``, so the multiply moves into the conv
before it (``W' = W * s`` over the conv's output channels) and the BN
becomes a bias, :class:`FoldedBN`. Conv and BN pair by the port's mmdet
names within one parent module (:func:`conv_bn_pairs`). A folded BN tail
still runs through kernel A, with a unit scale and the folded shift, its
residual and ReLU in the same pass: on the card the multiply the fold saves
costs nothing inside A, and a bf16 tail gives the bits of ``x + t`` as the
JAX ``FoldedBN`` adds its bias. Folding is an inference-only transform: a
folded model refuses a train-mode forward.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import parallel
from ..ops import affine_act

__all__ = ['BatchNorm2d', 'FoldedBN', 'MaskedBatchNorm2d', 'StateCache', 'begin_step',
           'conv_bn_pairs', 'fold_conv_bn', 'fold_model', 'fold_state', 'group_moments']


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
        if torch.is_grad_enabled():
            return affine_act.AffineAct.apply(x, s, t, residual, self.relu)
        return affine_act.affine_act(x, s, t, residual, self.relu)


class MaskedBatchNorm2d(BatchNorm2d):
    """BatchNorm of the sparse-import encoder: ``forward(x, mask,
    residual=None)`` is ``relu((x*s + t) * mask [+ residual])``, ``mask``
    [N, 1, H, W] bool (kernel A's masked form; the residual is zero outside
    the mask already). Train mode takes flax's masked statistics in float32
    (float64 for float64 inputs), its fast form: ``mean = sum(m x) / sum(m)``,
    ``var = max(0, sum(m x^2) / sum(m) - mean^2)``; with no active pixel
    both are NaN, as flax's ``mean(where=...)`` gives. In a process group
    each rank's two-pass moments of its active pixels (none: zeros) are
    combined over the ranks (:func:`group_moments`). eps 1e-3 and torch
    momentum 0.01 (flax 0.99): mmdet3d's SparseEncoder ``norm_cfg``. The
    running statistics update as :class:`BatchNorm2d` rounds them."""

    def __init__(self, num_features: int, **kw):
        super().__init__(num_features, relu=True, eps=1e-3, momentum=0.01, **kw)

    def batch_statistics(self, x: torch.Tensor, ct: torch.dtype, mask: torch.Tensor):
        xf = x.to(ct)
        m = mask.to(ct)
        if parallel.active():
            n = m.sum().reshape(1)
            mean = (xf * m).sum((0, 2, 3)) / n.clamp_min(1.0)
            d = (xf - mean.view(1, -1, 1, 1)) * m
            return group_moments(n, mean, (d * d).sum((0, 2, 3)))
        n = m.sum()
        mean = (xf * m).sum((0, 2, 3)) / n
        mean2 = (xf * xf * m).sum((0, 2, 3)) / n
        # torch.maximum, as jnp.maximum, keeps a NaN (an empty mask)
        return mean, torch.maximum(mean2 - mean * mean, torch.zeros((), dtype=ct,
                                                                    device=x.device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.contiguous(memory_format=torch.channels_last)
        if residual is not None:
            residual = residual.contiguous(memory_format=torch.channels_last)
        mask = mask.contiguous()
        s, t = self.batch_scale_shift(x, mask) if self.training else self.scale_shift()
        if torch.is_grad_enabled():
            return affine_act.AffineAct.apply(x, s, t, residual, True, mask)
        return affine_act.affine_act_masked(x, s, t, mask, residual)


def begin_step(model: nn.Module) -> None:
    """Mark the start of a train step for every :class:`BatchNorm2d` of
    ``model``: the next update of its running statistics rounds the old ones
    to the compute dtype first (see :meth:`BatchNorm2d.batch_scale_shift`)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m._first_update = True


class FoldedBN(nn.Module):
    """Bias-only stand-in for an eval :class:`BatchNorm2d` after folding:
    ``act(x + bias [+ residual])`` through kernel A with a unit scale. Its
    only state is ``bias`` (float32 [C]), under the BN's name."""

    def __init__(self, num_features: int, relu: bool = False, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.relu = relu
        self._scale_shift = StateCache()

    def scale_shift(self):
        """(ones, bias) float32 [C], made once per state of ``bias``."""
        def make():
            t = self.bias.float()
            return torch.ones_like(t), t
        return self._scale_shift.get((self.bias,), None, make)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            raise ValueError('BN folding is an inference-only transform; these weights were '
                             'folded by fold_conv_bn/fold_state and cannot be trained '
                             '(restore unfolded weights instead)')
        x = x.contiguous(memory_format=torch.channels_last)
        if residual is not None:
            residual = residual.contiguous(memory_format=torch.channels_last)
        s, t = self.scale_shift()
        if torch.is_grad_enabled():
            return affine_act.AffineAct.apply(x, s, t, residual, self.relu)
        return affine_act.affine_act(x, s, t, residual, self.relu)


# BN child name -> its conv's name in the same parent: ConvBN's ``bn`` ->
# ``conv`` (ASPP's ``atrous_conv``), ``bn{i}`` -> ``conv{i}`` (ResNet stems
# and blocks, ASPP), and in a Sequential index ``i`` -> ``i - 1`` (a
# downsample, a SECONDFPN deblock, the DepthNet's reduce conv, ASPP's pooled
# branch)
_PARTNER_RULES = (
    (re.compile(r'^bn$'), lambda m: ('conv', 'atrous_conv')),
    (re.compile(r'^bn(\d+)$'), lambda m: (f'conv{m.group(1)}',)),
    (re.compile(r'^(\d+)$'), lambda m: (str(int(m.group(1)) - 1),)),
)


def conv_bn_pairs(model: nn.Module) -> List[Tuple[str, str, int, float]]:
    """(conv name, BN name, the conv weight's output-channel axis, the BN's
    eps) of every :class:`BatchNorm2d` of ``model`` whose partner conv the
    naming rules find. The output channels are axis 0 of a Conv2d weight
    and axis 1 of a ConvTranspose2d's ([C_in, C_out, kH, kW])."""
    pairs = []
    for parent_name, parent in model.named_modules():
        children = dict(parent.named_children())
        for name, bn in children.items():
            # the sparse encoder's masked BNs pass through unfolded: the mask
            # multiplies between their affine and the residual
            if not isinstance(bn, BatchNorm2d) or isinstance(bn, MaskedBatchNorm2d):
                continue
            for pat, partners in _PARTNER_RULES:
                m = pat.match(name)
                if m is None:
                    continue
                conv = next((p for p in partners(m) if isinstance(
                    children.get(p), (nn.Conv2d, nn.ConvTranspose2d))), None)
                if conv is not None:
                    prefix = f'{parent_name}.' if parent_name else ''
                    transposed = isinstance(children[conv], nn.ConvTranspose2d)
                    pairs.append((prefix + conv, prefix + name, 1 if transposed else 0,
                                  bn.eps))
                break
    return pairs


_BN_ENTRIES = ('weight', 'running_mean', 'running_var', 'num_batches_tracked')


def fold_conv_bn(state: Mapping[str, torch.Tensor],
                 pairs: List[Tuple[str, str, int, float]]) -> Dict[str, torch.Tensor]:
    """Pure transform of a state dict (the model's, or an EMA shadow keyed
    like it) into the folded state dict.

    Each pair becomes: conv weight' = weight * s over its output channels
    with ``s = gamma / sqrt(var + eps)``; the BN keeps only ``bias`` = beta
    + (conv bias - mean) * s; a conv bias, if present, is zeroed (its effect
    moved into the folded bias). All in float32; entries of no pair pass
    through."""
    out = dict(state)
    for conv, bn, axis, eps in pairs:
        w = state[f'{conv}.weight'].float()
        gamma, beta, mean, var = (state[f'{bn}.{k}'].float() for k in
                                  ('weight', 'bias', 'running_mean', 'running_var'))
        svec = gamma / torch.sqrt(var + eps)
        conv_bias = state.get(f'{conv}.bias')
        cb = torch.zeros_like(mean) if conv_bias is None else conv_bias.float()
        out[f'{bn}.bias'] = beta + (cb - mean) * svec
        shape = [1] * w.ndim
        shape[axis] = -1
        out[f'{conv}.weight'] = w * svec.reshape(shape)
        if conv_bias is not None:
            out[f'{conv}.bias'] = torch.zeros_like(conv_bias)
        for k in _BN_ENTRIES:
            out.pop(f'{bn}.{k}', None)
    return out


@torch.no_grad()
def fold_model(model: nn.Module) -> List[Tuple[str, str, int, float]]:
    """Fold every conv+BN pair of ``model`` in place: the convs' weights and
    biases rewritten, each paired :class:`BatchNorm2d` replaced by a
    :class:`FoldedBN` holding the folded bias. Returns the pairs; raises
    when there are none (already folded, or no BN)."""
    pairs = conv_bn_pairs(model)
    if not pairs:
        raise ValueError('fold_state found no conv+BN pairs to fold — '
                         'wrong model or already folded?')
    folded = fold_conv_bn(model.state_dict(), pairs)
    for _, bn_name, _, _ in pairs:
        parent_name, _, child = bn_name.rpartition('.')
        parent = model.get_submodule(parent_name)
        bn = getattr(parent, child)
        setattr(parent, child, FoldedBN(bn.num_features, bn.relu,
                                        device=bn.weight.device).train(bn.training))
    model.load_state_dict(folded)
    return pairs


def fold_state(state):
    """Fold a train state's model in place, and its EMA shadow when it has
    one (JAX :205-209), for inference; returns the state."""
    pairs = fold_model(state.model)
    if state.ema is not None:
        state.ema = fold_conv_bn(state.ema, pairs)
    return state
