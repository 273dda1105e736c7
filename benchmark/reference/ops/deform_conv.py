"""Plain PyTorch versions of ``deform_conv``: a frozen copy of the port's plain
functions, with each public name bound to its plain version."""
from __future__ import annotations
import torch


def deform_sample_plain(x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [B, H, W, C], offsets [B, H, W, 18] float32
    (dy, dx per tap, taps row-major over the 3x3 window) -> [B, H*W, 9, C]
    in x's dtype, in the JAX package's order of operations."""
    b, h, w, c = x.shape
    nt = 9
    off = offsets.float().reshape(b, h, w, nt, 2)
    dev = x.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    k = torch.arange(3, dtype=torch.float32, device=dev) - 1
    base_dy, base_dx = torch.meshgrid(k, k, indexing='ij')
    py = ((ys[None, :, :, None] + base_dy.reshape(-1)) + off[..., 0]).reshape(b, h * w * nt)
    px = ((xs[None, :, :, None] + base_dx.reshape(-1)) + off[..., 1]).reshape(b, h * w * nt)
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    xf = x.reshape(b, h * w, c)
    batch = torch.arange(b, device=dev)[:, None]
    sampled = torch.zeros(b, h * w * nt, c, dtype=x.dtype, device=dev)
    for dy, dx, cw in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                       (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yi, xi = y0i + dy, x0i + dx
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        flat = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        rows = xf[batch, flat]                                   # [B, H*W*9, C]
        cwm = torch.where(inb, cw, 0.0).to(x.dtype)
        sampled = sampled + rows * cwm[..., None]
    return sampled.reshape(b, h * w, nt, c)


def pack_weight(weight: torch.Tensor, groups: int, dtype: torch.dtype) -> torch.Tensor:
    """mmcv's kernel [C_out, C_in/g, 3, 3] -> [g, 9 * C_in/g, C_out/g] in
    ``dtype``, row ``tap * C_in/g + c`` (taps row-major over the 3x3
    window): the columns' order, which the fused kernel reads."""
    o, cg = weight.shape[:2]
    g = groups
    w = weight.reshape(g, o // g, cg, 9).permute(0, 3, 2, 1).reshape(g, 9 * cg, o // g)
    return w.to(dtype).contiguous()


def deform_conv3x3_plain(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, groups: int) -> torch.Tensor:
    """Plain PyTorch version: :func:`deform_sample_plain`, the grouped
    product as one batched matrix product of the columns and the kernel in
    x's dtype, summed in fp32 (the products of bf16 values are exact there;
    no reduced-precision split reductions; float64 inputs sum in float64)
    and rounded to float32, where the JAX package's
    ``preferred_element_type=jnp.float32`` rounds it, then once to x's
    dtype, then the bias in x's dtype. x [B, H, W, C], offsets [B, H, W, 18]
    float32, weight [g, 9 * C/g, C_out/g] (:func:`pack_weight`), bias
    [C_out] -> [B, H, W, C_out] in x's dtype."""
    b, h, w, c = x.shape
    g = groups
    ct = torch.promote_types(x.dtype, torch.float32)
    cols = deform_sample_plain(x, offsets)                              # [B, HW, 9, C]
    cols = cols.reshape(b * h * w, 9, g, c // g).permute(2, 0, 1, 3).reshape(g, -1, 9 * c // g)
    out = torch.bmm(cols.to(ct), weight.to(x.dtype).to(ct)).float().to(x.dtype)  # [g, BHW, og]
    return out.permute(1, 0, 2).reshape(b, h, w, -1) + bias.to(x.dtype)


deform_conv3x3 = deform_conv3x3_plain
