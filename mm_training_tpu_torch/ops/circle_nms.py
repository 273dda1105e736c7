"""Kernel K3: circle NMS keep mask.

The port of ``mm_training_tpu/ops/circle_nms.py::circle_nms_mask``: boxes are
visited in descending-score order, and a box is suppressed when its squared
centre distance to a kept higher-scoring box is <= ``thresh`` (the raw
``min_radius`` value, as CenterPoint compares it). The CUDA source is
``csrc/circle_nms.cu`` (one block per row: a K x K bitmask in shared memory
and one sequential sweep); see the note there for its bound.

Rows are batched: the decode stacks every (batch, task) row into one call,
and each row carries its own threshold. The stable descending sort stays
``torch.sort(stable=True)`` in both versions.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from . import build

__all__ = ['circle_nms_mask', 'circle_nms_mask_plain']


def _sorted_rows(centers, scores, valid):
    """Stable descending order of ``where(valid, score, -inf)`` per row,
    with the centres and validity gathered into that order."""
    key = torch.where(valid, scores, torch.full_like(scores, -float('inf')))
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    cs = torch.gather(centers, 1, order[..., None].expand(-1, -1, 2))
    return order, cs, torch.gather(valid, 1, order)


def _row_thresholds(thresh, rows: int, device) -> torch.Tensor:
    t = torch.as_tensor(thresh, dtype=torch.float32, device=device)
    return t.expand(rows).contiguous() if t.dim() == 0 else t


def circle_nms_mask_plain(centers: torch.Tensor, scores: torch.Tensor,
                          valid: torch.Tensor,
                          thresh: Union[float, torch.Tensor]) -> torch.Tensor:
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
    p = ctypes.c_void_p
    lib.circle_nms.argtypes = [p, p, p, p, p, ctypes.c_longlong, ctypes.c_int, p]
    lib.circle_nms.restype = ctypes.c_int
    return lib


def circle_nms_mask(centers: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor,
                    thresh: Union[float, torch.Tensor]) -> torch.Tensor:
    """Keep mask of circle NMS, per row.

    Args:
      centers: [R, K, 2] float32 box centres (x, y); K <= 1024 on the card
        (the decode's K is ``max_num`` = 500).
      scores: [R, K] scores (used only for ordering).
      valid: [R, K] bool; invalid slots are never kept and never suppress.
      thresh: a float, or a [R] tensor of per-row thresholds on the squared
        centre distance.

    Returns [R, K] bool in slot order. CPU tensors take
    :func:`circle_nms_mask_plain`; CUDA tensors launch the kernel.
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
    if k > 1024:
        raise ValueError(f'circle_nms_mask: the kernel takes K <= 1024 slots a row, '
                         f'got {k}')
    th = _row_thresholds(thresh, r, centers.device)
    if th.shape != (r,):
        raise ValueError(f'circle_nms_mask: thresh must be a float or [{r}], '
                         f'got {tuple(th.shape)}')
    order, cs, val = _sorted_rows(centers, scores, valid)
    order, cs, val = order.contiguous(), cs.contiguous(), val.contiguous()
    keep = torch.empty_like(val)
    lib = _lib()
    with torch.cuda.device(centers.device):
        code = lib.circle_nms(cs.data_ptr(), val.data_ptr(), order.data_ptr(),
                              th.data_ptr(), keep.data_ptr(), r, k,
                              torch.cuda.current_stream(centers.device).cuda_stream)
    build.check(lib, code, 'circle_nms_mask')
    circle_nms_mask.launches += 1
    return keep


circle_nms_mask.launches = 0
