"""Plain PyTorch versions of ``circle_nms``: a frozen copy of the port's plain
functions, with each public name bound to its plain version."""
from __future__ import annotations
import numbers
from typing import Sequence, Union
import torch


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


circle_nms_mask = circle_nms_mask_plain
