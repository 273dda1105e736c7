"""The head's BEV sharded along W over the model axis.

The port of the JAX package's spatial partitioning: the fused BEV is
constrained to be sharded along W over the mesh's model axis before the
head (``mm_training_tpu/models/bev_depth.py:99-102``), and XLA's SPMD
partitioner runs the head, the loss and the decode on the W shards, with
the halo exchanges each op needs. Here each rank of a model group holds one
contiguous W range and the exchanges are written out:

* :func:`shard_w` takes this rank's W range of the fused BEV; its backward
  all-gathers the ranges' gradients over the model group, so everything
  before it (the encoders, the fusion), which the model peers run
  replicated on the same rows, gets the whole BEV's gradient;
* :func:`halo_pad` gives an op that reads beyond its own columns the
  columns it reads from the neighbouring shards (one all-gather of the edge
  columns over the model group), zeros (or ``-inf`` before a max-pool) at
  the global edges; its backward adds each halo's gradient back into the
  neighbour's columns (one all-gather). :func:`conv2d` and
  :func:`max_pool2d` run a module's conv or the stem's pool on a shard so,
  the halo derived from (kernel, stride, padding, dilation);
* :func:`gather_w` all-gathers the pred maps along W for the decode, and
  :func:`local_w` takes this rank's columns of whole maps back.

Shards are aligned to the head's total stride, so each op's shard of its
output is the output of its shard of the input: a shard's first input column
is a multiple of every stride. Without a model axis (``axis`` None) every
function is the plain op, and a model computes what it did before.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .collectives import all_gather
from .mesh import Axis

__all__ = ['check_columns', 'columns', 'conv2d', 'gather_w', 'halo', 'halo_pad', 'local_w',
           'max_pool2d', 'shard_w']


def halo(kernel: int, stride: int, padding: int, dilation: int = 1) -> Tuple[int, int]:
    """(left, right) columns an op of this (kernel, stride, padding,
    dilation) along W reads beyond a stride-aligned shard: output column
    ``j`` reads input columns ``stride*j - padding`` to ``stride*j - padding
    + dilation*(kernel-1)``. The 3x3/1 conv reads (1, 1), the 3x3/2 conv and
    max-pool (1, 0), the 7x7/2 stem (3, 2), a 1x1/2 conv nothing."""
    return padding, max(0, dilation * (kernel - 1) - padding - (stride - 1))


def columns(width: int, axis: Axis) -> Tuple[int, int]:
    """Columns ``[lo, hi)`` of a map ``width`` wide that this rank holds."""
    per = width // axis.size
    return axis.index * per, (axis.index + 1) * per


def check_columns(width: int, stride: int, axis: Optional[Axis]) -> None:
    """Raise, naming ``model_parallel``, unless ``width`` splits into
    ``axis.size`` shards that are each a multiple of ``stride``."""
    if axis is not None and width % (axis.size * stride):
        raise ValueError(f'model_parallel={axis.size}: a BEV {width} cells wide does not split '
                         f'into {axis.size} shards aligned to the head\'s total stride {stride}')


class _ShardW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        lo, hi = columns(x.shape[-1], axis)
        return x[..., lo:hi].contiguous(memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, g):
        full = torch.cat(all_gather(g.contiguous(memory_format=torch.channels_last),
                                    ctx.axis.group), dim=-1)
        return full.contiguous(memory_format=torch.channels_last), None


def shard_w(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """This rank's W range of ``x`` [B, C, H, W] (channels_last); the
    backward gives every model peer the whole gradient."""
    if axis is None:
        return x
    return _ShardW.apply(x, axis)


def _fill(x, width, value):
    shape = x.shape[:-1] + (width,)
    return x.new_full(shape, value)


class _HaloPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, axis, value):
        ctx.meta = (left, right, axis, x.shape[-1])
        i, n = axis.index, axis.size
        # my first `right` columns are my left neighbour's right halo, my
        # last `left` columns my right neighbour's left halo
        edges = all_gather(torch.cat([x[..., :right], x[..., x.shape[-1] - left:]], -1),
                           axis.group)
        lh = edges[i - 1][..., right:] if i > 0 else _fill(x, left, value)
        rh = edges[i + 1][..., :right] if i < n - 1 else _fill(x, right, value)
        return torch.cat([lh, x, rh], -1).contiguous(memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, g):
        left, right, axis, w = ctx.meta
        i, n = axis.index, axis.size
        gx = g[..., left:left + w].clone()
        sent = all_gather(torch.cat([g[..., :left], g[..., left + w:]], -1), axis.group)
        if i < n - 1:      # my right neighbour's left halo is my last columns
            gx[..., w - left:] += sent[i + 1][..., :left]
        if i > 0:          # my left neighbour's right halo is my first columns
            gx[..., :right] += sent[i - 1][..., left:]
        return gx.contiguous(memory_format=torch.channels_last), None, None, None, None


def halo_pad(x: torch.Tensor, left: int, right: int, axis: Optional[Axis],
             value: float = 0.0) -> torch.Tensor:
    """``x`` [B, C, H, w] (a W shard) with ``left`` columns of the left
    neighbour's shard before it and ``right`` of the right neighbour's after
    it, ``value`` beyond the global edges; ``x`` itself without a model
    axis or a halo. A halo wider than a shard raises."""
    if axis is None or left == right == 0:
        return x
    if max(left, right) > x.shape[-1]:
        raise ValueError(f'a halo of ({left}, {right}) columns on a shard {x.shape[-1]} wide: '
                         'lower model_parallel')
    return _HaloPad.apply(x, left, right, axis, value)


def _w_geometry(conv: nn.Conv2d):
    return conv.kernel_size[1], conv.stride[1], conv.padding[1], conv.dilation[1]


def conv2d(conv: nn.Conv2d, x: torch.Tensor, axis: Optional[Axis],
           padded: bool = False) -> torch.Tensor:
    """``conv(x)`` on a W shard: the halo padded (``padded``: ``x`` holds it
    already), then the conv with no padding along W. ``conv(x)`` without a
    model axis."""
    if axis is None:
        return conv(x)
    if not padded:
        x = halo_pad(x, *halo(*_w_geometry(conv)), axis)
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, (conv.padding[0], 0),
                    conv.dilation, conv.groups)


def max_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int,
               axis: Optional[Axis]) -> torch.Tensor:
    """``F.max_pool2d(x, kernel, stride, padding)`` on a W shard: the halo
    padded with ``-inf`` beyond the global edges, as the pool's padding
    acts."""
    if axis is None:
        return F.max_pool2d(x, kernel, stride, padding)
    x = halo_pad(x, *halo(kernel, stride, padding), axis, -float('inf'))
    return F.max_pool2d(x, kernel, stride, (padding, 0))


def gather_w(preds: List[Dict[str, torch.Tensor]], axis: Optional[Axis]
             ) -> List[Dict[str, torch.Tensor]]:
    """The whole NHWC maps [B, H, W, C] from every model peer's W shard, one
    all-gather a map (not differentiable: the decode and the eval losses
    take no gradient); ``preds`` without a model axis."""
    if axis is None:
        return preds
    return [{k: torch.cat(all_gather(v, axis.group), dim=2) for k, v in p.items()}
            for p in preds]


def local_w(preds: List[Dict[str, torch.Tensor]], axis: Optional[Axis]
            ) -> List[Dict[str, torch.Tensor]]:
    """This rank's columns of whole NHWC maps (views)."""
    if axis is None:
        return preds
    out = []
    for p in preds:
        lo, hi = columns(next(iter(p.values())).shape[2], axis)
        out.append({k: v[:, :, lo:hi] for k, v in p.items()})
    return out
