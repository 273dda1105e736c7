"""The all-reduces of a data-parallel step.

In the JAX package a step over a device mesh equals one device on the global
batch by construction: under the global-view jit every sum over the batch is
a cross-device sum (``mm_training_tpu/training/train_step.py:8-10``). In the
port each rank holds its rows only, so what the step sums over the batch is
summed over the group here, by hand:

* train-mode BatchNorm's per-channel moments
  (``models/bn_fold.py::group_moments``), through :func:`all_reduce_sum`,
  whose backward is the same all-reduce, so every rank's input gradient
  sees the global statistics' gradient;
* the loss normalizers (``models/centerpoint_head.py::detection_loss``,
  ``training/train_step.py::depth_loss_fn``), clamped after the sum, as the
  global-view jit clamps the global count;
* the gradients, summed (each rank's loss is its rows' sum over the global
  normalizers) in flat buckets before the optimizer reads their norm
  (:func:`all_reduce_buckets`), and the reported losses.

On the model axis (``parallel/spatial.py``) the W shards of the head meet in
all-gathers over the model group (:func:`all_gather`): gloo gathers no CUDA
tensor, so there a gather goes through pinned host buffers (the compute stays
on the card). Without a process group every helper is the identity, and a
single process computes what it did before. ``COUNTS`` counts the
collectives and their bytes since the last :func:`reset_counts`.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from .multihost import active

__all__ = ['COUNTS', 'BUCKET_BYTES', 'all_gather', 'all_reduce_buckets', 'all_reduce_sum',
           'broadcast_buckets', 'reset_counts']

# flat buffers of at most this many bytes a collective (a bucket holds one
# tensor at least, whatever its size)
BUCKET_BYTES = 25 << 20
COUNTS: Dict[str, int] = {'all_reduce': 0, 'all_reduce_bytes': 0, 'broadcast': 0,
                          'broadcast_bytes': 0, 'all_gather': 0, 'all_gather_bytes': 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    COUNTS['all_reduce'] += 1
    COUNTS['all_reduce_bytes'] += t.numel() * t.element_size()
    dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group, backward the same sum of the output gradients:
    with the ranks' losses summed, d(total)/d(input of rank r) is the sum
    over ranks of d(loss of rank r')/d(output). The function of
    ``torch.distributed.nn.functional.all_reduce``, which PyTorch marks as
    deprecated."""

    @staticmethod
    def forward(ctx, t):
        return _all_reduce_(t.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.clone(memory_format=torch.contiguous_format))


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """``t`` of every rank of ``group``, in the group's rank order, on
    ``t``'s device (not differentiable; ``parallel/spatial.py`` wraps it).
    NCCL gathers into one tensor. gloo gathers the bytes of CPU tensors, and
    a CUDA tensor there goes through a pinned host copy and back."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    COUNTS['all_gather'] += 1
    COUNTS['all_gather_bytes'] += t.numel() * t.element_size()
    if dist.get_backend(group) != 'gloo':
        out = t.new_empty((n,) + tuple(t.shape))
        dist.all_gather_into_tensor(out, t, group=group)
        return list(out.unbind(0))
    host = t
    if t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
    raw = host.reshape(-1).view(torch.uint8)       # any dtype: gloo moves the bytes
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=group)
    return [p.view(t.dtype).view(t.shape).to(t.device) for p in parts]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the group's ranks, differentiable; ``t`` itself
    without a group."""
    if not active():
        return t
    return _AllReduceSum.apply(t)


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` grouped in order into runs of one dtype and
    device of at most :data:`BUCKET_BYTES` each."""
    out: List[List[int]] = []
    size = 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if (not out or size + nbytes > BUCKET_BYTES
                or (t.dtype, t.device) != (tensors[out[-1][0]].dtype,
                                           tensors[out[-1][0]].device)):
            out.append([])
            size = 0
        out[-1].append(i)
        size += nbytes
    return out


def all_reduce_buckets(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors summed over the group, one all-reduce a flat bucket of
    :data:`BUCKET_BYTES`; returned as views into the buckets. ``tensors``
    as they are without a group."""
    tensors = list(tensors)
    if not active():
        return tensors
    out: List[torch.Tensor] = list(tensors)
    for idx in _buckets(tensors):
        flat = _all_reduce_(torch.cat([tensors[i].reshape(-1) for i in idx]))
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


@torch.no_grad()
def broadcast_buckets(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s, one broadcast a
    flat bucket; nothing without a group."""
    tensors = list(tensors)
    if not active():
        return
    for idx in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        COUNTS['broadcast'] += 1
        COUNTS['broadcast_bytes'] += flat.numel() * flat.element_size()
        dist.broadcast(flat, src)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            tensors[i].copy_(part.view(tensors[i].shape))
