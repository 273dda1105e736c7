"""Kernel K3: circle NMS keep mask.

The port of ``mm_training_tpu/ops/circle_nms.py::circle_nms_mask``: boxes are
visited in descending-score order, and a box is suppressed when its squared
centre distance to a kept higher-scoring box is <= ``thresh`` (the raw
``min_radius`` value, as CenterPoint compares it). The CUDA source is
``csrc/circle_nms.cu``: one launch a call, one thread-block cluster a row,
which sorts the row, builds its K x K bitmask across the cluster and sweeps
it; see the note there for its bound.

Rows are batched: the decode stacks every (batch, task) row into one call,
and each row carries its own threshold: a float for all rows, a tuple of
per-task floats (row r uses ``thresh[r % T]``, rows ordered (batch, task);
passed to the kernel by value, so no host-to-device copy), or an [R]
tensor. The order is the stable descending one: ``torch.sort(stable=True)``
in the plain version, a bitonic sort of (score, slot) in the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import numbers
from typing import Sequence, Union

import torch

from . import build

__all__ = ['circle_nms_mask', 'circle_nms_mask_plain']

MAX_TASKS = 16      # thresholds the kernel takes by value
MAX_SLOTS = 1024    # slots a row the kernel takes (K)
Thresh = Union[float, Sequence[float], torch.Tensor]


def _sorted_rows(centers, scores, valid):
    """Stable descending order of ``where(valid, score, -inf)`` per row,
    with the centres and validity gathered into that order."""
    key = torch.where(valid, scores, torch.full_like(scores, -float('inf')))
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    cs = torch.gather(centers, 1, order[..., None].expand(-1, -1, 2))
    return order, cs, torch.gather(valid, 1, order)


def _per_task(thresh, rows: int):
    """The thresholds as a tuple of floats (row r uses ``[r % T]``), or None
    for a tensor."""
    if isinstance(thresh, torch.Tensor):
        return None
    vals = (thresh,) if isinstance(thresh, numbers.Real) else tuple(thresh)
    if not vals or not all(isinstance(v, numbers.Real) for v in vals) or rows % len(vals):
        raise ValueError(f'circle_nms_mask: thresh must be a float, per-task floats that '
                         f'divide the {rows} rows, or an [R] tensor; got {thresh!r}')
    return tuple(float(v) for v in vals)


def _row_thresholds(thresh, rows: int, device) -> torch.Tensor:
    vals = _per_task(thresh, rows)
    if vals is not None:
        return torch.tensor(vals, dtype=torch.float32, device=device).repeat(rows // len(vals))
    t = thresh.to(device=device, dtype=torch.float32)
    return t.expand(rows) if t.dim() == 0 else t


def circle_nms_mask_plain(centers: torch.Tensor, scores: torch.Tensor,
                          valid: torch.Tensor, thresh: Thresh) -> torch.Tensor:
    """Plain PyTorch version: the full distance matrix and a K-step loop of
    masked updates, all rows at once."""
    r, k = scores.shape
    th = _row_thresholds(thresh, r, centers.device)
    order, cs, val = _sorted_rows(centers, scores, valid)
    diff = cs[:, :, None, :] - cs[:, None, :, :]
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]   # [R, K, K]
    close = d2 <= th[:, None, None]
    later = torch.arange(k, device=centers.device)
    keep = val.clone()
    for i in range(k):
        kept_i = keep[:, i] & val[:, i]
        keep &= ~(kept_i[:, None] & close[:, i] & (later > i))
    return torch.zeros_like(keep).scatter_(1, order, keep) & valid


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load('circle_nms')
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.circle_nms.argtypes = [p, i64, i64, p, p, p, i32, p, i32, p, i64, i32, p]
    lib.circle_nms.restype = ctypes.c_int
    return lib


def circle_nms_mask(centers: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, thresh: Thresh) -> torch.Tensor:
    """Keep mask of circle NMS, per row.

    Args:
      centers: [R, K, 2] float32 box centres (x, y), the last dimension
        contiguous (a view of the boxes is fine); K <= MAX_SLOTS on the card (the
        decode's K is ``max_num`` = 500).
      scores: [R, K] scores (used only for ordering).
      valid: [R, K] bool; invalid slots are never kept and never suppress.
      thresh: the threshold on the squared centre distance: a float, a
        tuple of per-task floats (row r uses ``thresh[r % T]``, T <= 16 on
        the card), or an [R] tensor.

    Returns [R, K] bool in slot order. CPU tensors take
    :func:`circle_nms_mask_plain`; CUDA tensors launch the kernel once.
    """
    if (centers.dim() != 3 or centers.shape[2] != 2
            or scores.shape != centers.shape[:2] or valid.shape != scores.shape
            or valid.dtype != torch.bool or centers.dtype != torch.float32):
        raise ValueError(f'circle_nms_mask: centers [R, K, 2] float32, scores and '
                         f'bool valid [R, K]; got {tuple(centers.shape)} '
                         f'{centers.dtype}, {tuple(scores.shape)}, '
                         f'{tuple(valid.shape)} {valid.dtype}')
    if centers.device.type == 'cpu':
        return circle_nms_mask_plain(centers, scores, valid, thresh)
    if centers.device.type != 'cuda':
        raise ValueError(f'circle_nms_mask: unsupported device {centers.device}')
    r, k = scores.shape
    if k > MAX_SLOTS:
        raise ValueError(f'circle_nms_mask: the kernel takes K <= {MAX_SLOTS} slots a row, '
                         f'got {k}')
    vals = _per_task(thresh, r)
    if vals is None:
        th = thresh.to(torch.float32)
        if th.device != centers.device or th.shape not in ((), (r,)):
            raise ValueError(f'circle_nms_mask: a thresh tensor must be [] or [{r}] on '
                             f'{centers.device}, got {tuple(th.shape)} on {th.device}')
        th = th.contiguous()
        th_ptr, th_step, n_vals = th.data_ptr(), int(th.dim() == 1), 0
    elif len(vals) > MAX_TASKS:
        raise ValueError(f'circle_nms_mask: at most {MAX_TASKS} per-task thresholds, '
                         f'got {len(vals)}')
    else:
        th_ptr, th_step, n_vals = None, 0, len(vals)
    if centers.stride(2) != 1:
        centers = centers.contiguous()
    scores = scores.to(torch.float32).contiguous()
    valid = valid.contiguous()
    keep = torch.empty_like(valid)
    if r * k == 0:
        return keep
    host_vals = (ctypes.c_float * MAX_TASKS)(*(vals or ()))
    lib = _lib()
    with torch.cuda.device(centers.device):
        code = lib.circle_nms(centers.data_ptr(), centers.stride(0), centers.stride(1),
                              scores.data_ptr(), valid.data_ptr(), th_ptr, th_step,
                              host_vals, n_vals, keep.data_ptr(), r, k,
                              torch.cuda.current_stream(centers.device).cuda_stream)
    build.check(lib, code, 'circle_nms_mask')
    circle_nms_mask.launches += 1
    return keep


circle_nms_mask.launches = 0
