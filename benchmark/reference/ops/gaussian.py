"""Plain PyTorch versions of ``gaussian``: a frozen copy of the port's plain
functions, with each public name bound to its plain version."""
from __future__ import annotations
from typing import Sequence, Tuple
import functools

import torch


@functools.lru_cache(maxsize=None)
def _divisor(b: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):     # a normal tensor, whichever mode made it
        return torch.full((), b, dtype=dtype, device=device)


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` with true division: the divisor is a tensor on ``a``'s
    device, because dividing a CUDA tensor by a Python number multiplies by
    its reciprocal, which rounds differently from the JAX package. The
    divisor is made once per (value, dtype, device) and kept, so a call
    makes no host-to-device copy."""
    return a / _divisor(float(b), a.dtype, a.device)


def gaussian_radius(det_size: Sequence[torch.Tensor], min_overlap: float) -> torch.Tensor:
    """CornerNet radius rule (mmdet3d ``gaussian_radius``): the smallest of
    three quadratic roots. ``det_size = (height, width)`` in feature cells,
    float32 tensors; each step rounds as the JAX function's does."""
    height, width = det_size
    b1 = height + width
    c1 = true_div(width * height * (1 - min_overlap), 1 + min_overlap)
    sq1 = torch.sqrt(torch.clamp_min(b1 * b1 - 4.0 * c1, 0.0))
    r1 = true_div(b1 + sq1, 2.0)

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = torch.sqrt(torch.clamp_min(b2 * b2 - 16.0 * c2, 0.0))
    r2 = true_div(b2 + sq2, 2.0)

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = torch.sqrt(torch.clamp_min(b3 * b3 - (4 * a3) * c3, 0.0))
    r3 = true_div(b3 + sq3, 2.0)
    return torch.minimum(torch.minimum(r1, r2), r3)


def _check(centers: torch.Tensor, radii: torch.Tensor, valid: torch.Tensor) -> None:
    if (centers.dim() != 3 or centers.shape[2] != 2 or centers.dtype != torch.int32
            or radii.shape != centers.shape[:2] or radii.dtype != torch.int32
            or valid.dim() != 3 or valid.shape[0] != centers.shape[0]
            or valid.shape[2] != centers.shape[1] or valid.dtype != torch.bool):
        raise ValueError(f'draw_heatmap: centers [B, K, 2] int32, radii [B, K] int32, '
                         f'valid [B, M, K] bool; got {tuple(centers.shape)} '
                         f'{centers.dtype}, {tuple(radii.shape)} {radii.dtype}, '
                         f'{tuple(valid.shape)} {valid.dtype}')
    if not centers.device == radii.device == valid.device:
        raise ValueError('draw_heatmap: centers, radii and valid on different devices')


def draw_heatmap_plain(centers: torch.Tensor, radii: torch.Tensor,
                       valid: torch.Tensor, hw: Tuple[int, int],
                       chunk: int = 32) -> torch.Tensor:
    """Plain PyTorch version, the JAX formulation batched: each chunk of
    ``chunk`` objects is rendered over the whole map and max-combined."""
    _check(centers, radii, valid)
    h, w = hw
    b, k, _ = centers.shape
    dev = centers.device
    ys = torch.arange(h, dtype=torch.int32, device=dev).view(1, 1, h, 1)
    xs = torch.arange(w, dtype=torch.int32, device=dev).view(1, 1, 1, w)
    out = torch.zeros(b, valid.shape[1], h, w, dtype=torch.float32, device=dev)
    for k0 in range(0, k, chunk):
        c, r = centers[:, k0:k0 + chunk], radii[:, k0:k0 + chunk]
        dx = xs - c[..., 0, None, None]                        # [B, c, 1, W]
        dy = ys - c[..., 1, None, None]                        # [B, c, H, 1]
        sigma = true_div(2.0 * r.float() + 1.0, 6.0)[..., None, None]
        dxf, dyf = dx.float(), dy.float()
        g = torch.exp(-(dxf * dxf + dyf * dyf) / (2.0 * (sigma * sigma)))
        rr = r[..., None, None]
        inside = (dx.abs() <= rr) & (dy.abs() <= rr)
        g = torch.where(inside, g, 0.0)                        # [B, c, H, W]
        v = valid[:, :, k0:k0 + chunk, None, None]             # [B, M, c, 1, 1]
        out = torch.maximum(out, torch.where(v, g[:, None], 0.0).amax(2))
    return out


draw_heatmap = draw_heatmap_plain
