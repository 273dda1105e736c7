"""Plain PyTorch versions of ``warp``: a frozen copy of the port's plain
functions, with each public name bound to its plain version."""
from __future__ import annotations
import torch
import torch.nn.functional as F


def _inverse(mat: torch.Tensor) -> torch.Tensor:
    """[B, 3, 3] inverse in closed form, the kernel's order: the adjugate
    over det = (a A + b B) + c C, each product, difference and sum rounded."""
    m = mat.float()
    a, b, c, d, e, f, g, h, i = (m[:, r, k] for r in range(3) for k in range(3))
    adj = (e * i - f * h, c * h - b * i, b * f - c * e,
           f * g - d * i, a * i - c * g, c * d - a * f,
           d * h - e * g, b * g - a * h, a * e - b * d)
    det = (a * adj[0] + b * adj[3]) + c * adj[6]
    return torch.stack(adj, -1).view(-1, 3, 3) / det[:, None, None]


def _warp_plain(img: torch.Tensor, minv: torch.Tensor) -> torch.Tensor:
    b, h, w, c = img.shape
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)

    def coord(i):     # (x, y, 1) @ minv^T, left to right
        m = [minv[:, i, j, None, None] for j in range(3)]
        return (xs * m[0] + ys * m[1]) + m[2]

    p0, p1, p2 = coord(0), coord(1), coord(2)
    sx, sy = p0 / p2, p1 / p2
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = img.reshape(b, h * w, c)
    batch = torch.arange(b, device=dev)[:, None]

    ct = torch.promote_types(img.dtype, torch.float32)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        at = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, h * w)
        val = flat[batch, at].reshape(b, h, w, c)
        return torch.where(inb[..., None], val, 0.0).to(ct)

    v00, v01 = tap(x0i, y0i), tap(x0i + 1, y0i)
    v10, v11 = tap(x0i, y0i + 1), tap(x0i + 1, y0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return (top * (1 - wy) + bot * wy).to(img.dtype)


def warp_affine_nhwc_plain(img: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_affine_nhwc`."""
    return _warp_plain(img, _inverse(mat))


def bda_pixel_matrix(bda_mat: torch.Tensor, hw) -> torch.Tensor:
    """[B, 3, 3] float32 pixel transform of the BEV augmentation: the xy
    block of ``bda_mat`` ([B, 4, 4] or [B, 3, 3]) about the centre pixel
    c = ((W-1)/2, (H-1)/2), ``M = [lin | c - lin @ c]``, with
    ``t = c - (lin[:, 0] cx + lin[:, 1] cy)`` in that order (the kernel's)."""
    h, w = hw
    lin = bda_mat[:, :2, :2].float()
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    tx = cx - (lin[:, 0, 0] * cx + lin[:, 0, 1] * cy)
    ty = cy - (lin[:, 1, 0] * cx + lin[:, 1, 1] * cy)
    zero = torch.zeros_like(tx)
    return torch.stack([lin[:, 0, 0], lin[:, 0, 1], tx, lin[:, 1, 0], lin[:, 1, 1], ty,
                        zero, zero, zero + 1.0], -1).view(-1, 3, 3)


def bda_bev_warp_plain(bev: torch.Tensor, bda_mat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bda_bev_warp`."""
    return warp_affine_nhwc_plain(bev, bda_pixel_matrix(bda_mat, bev.shape[1:3]))


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of an NCHW map to ``out_hw`` (align_corners False,
    antialiased when it shrinks, as ``jax.image.resize`` is), computed in
    float32 (float64 for a float64 map) and rounded to ``x``'s dtype."""
    ct = torch.promote_types(x.dtype, torch.float32)
    return F.interpolate(x.to(ct), size=tuple(out_hw), mode='bilinear', align_corners=False,
                         antialias=True).to(x.dtype)


bda_bev_warp = bda_bev_warp_plain
