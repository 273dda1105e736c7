"""Kernel K4's and K5's inputs at a camera config's shapes, K4's laid out as
the path hands them over (``models/lss_fpn.py``), and the tolerance that
holds the fused K5 to its plain version. Shared by ``chip_smoke.py``, the
card tests and ``exps/ab_kernels.py``."""
from __future__ import annotations

import numpy as np
import torch

from ..configs import Config
from ..data import make_fake_batch
from ..models.lss_fpn import LSSFPN
from ..ops import deform_conv

__all__ = ['SPLAT_LAYOUTS', 'deform_inputs', 'deform_outside_tolerance', 'deform_shape',
           'splat_inputs']

# 'channels_last': the softmax over bins in channels-last memory, as the depth
# oracle's ``where`` leaves it; 'slice': the softmax written into the
# DepthNet output and read in place; 'nchw': the softmax without the oracle;
# each with ctx the permuted channels-last slice of that output.
# 'contiguous': contiguous copies of both.
SPLAT_LAYOUTS = ('channels_last', 'slice', 'nchw', 'contiguous')


def splat_inputs(cfg: Config, gen: torch.Generator, layout: str = 'channels_last',
                 dtype: torch.dtype = torch.bfloat16, seed: int = 8):
    """(depth, ctx, idx, zvalid, n_cells) on ``gen``'s device: the fake rig's
    own splat indices and z mask for ``cfg``'s batch (fake batch ``seed``)
    and a random DepthNet output of ``dtype`` from ``gen``, depth and ctx in
    one of :data:`SPLAT_LAYOUTS`."""
    if layout not in SPLAT_LAYOUTS:
        raise ValueError(f'splat_inputs: layout one of {SPLAT_LAYOUTS}, got {layout!r}')
    dev = gen.device
    bb = cfg.get_backbone_conf()
    batch = make_fake_batch(cfg, seed=seed)
    with torch.device('meta'):
        lss = LSSFPN(bb)
    idx, zvalid = lss.splat_indices(torch.as_tensor(batch['sensor2ego'][:, 0], device=dev),
                                    torch.as_tensor(batch['intrin'][:, 0], device=dev))
    d, (fh, fw), c = bb.depth_channels, bb.feat_hw, bb.output_channels
    feat = torch.randn(idx.shape[0], d + c, fh, fw, generator=gen, device=dev).to(dtype)
    feat = feat.contiguous(memory_format=torch.channels_last)
    ctx = feat[:, d:].permute(0, 2, 3, 1)
    if layout == 'slice':
        depth = feat[:, :d]
        depth.copy_(depth.softmax(1))
    elif layout == 'nchw':
        depth = feat[:, :d].softmax(1).contiguous()
    else:
        depth = feat[:, :d].softmax(1).contiguous(memory_format=torch.channels_last)
        if layout == 'contiguous':
            depth, ctx = depth.contiguous(), ctx.contiguous()
    return depth, ctx, idx, zvalid, int(np.prod(bb.bev_hw))


def deform_shape(cfg: Config):
    """(B * cameras, fH, fW, C) of the DepthNet's deformable conv input at
    ``cfg``'s batch: 4 x 44 x 80 x 512 for a ``lidar_cam_radar`` request."""
    bb = cfg.get_backbone_conf()
    return (cfg.batch_size * cfg.num_cameras, *bb.feat_hw, bb.depth_net_conf.mid_channels)


def deform_inputs(shape, groups: int, gen: torch.Generator,
                  dtype: torch.dtype = torch.bfloat16, max_offset: float = 3.0):
    """(x, offsets, weight, bias) of :func:`~mm_training_tpu_torch.ops.
    deform_conv.deform_conv3x3` on ``gen``'s device: x [B, H, W, C] N(0, 1)
    in ``dtype``; offsets uniform in [-max_offset, max_offset] px with a
    quarter snapped to whole pixels; a He-scaled kernel (C -> C) packed for
    the fused op and a N(0, 0.1) bias, both in ``dtype``."""
    b, h, w, c = shape
    dev = gen.device
    x = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
    off = (torch.rand(b, h, w, 18, generator=gen, device=dev) * 2 - 1) * max_offset
    snap = torch.rand(off.shape, generator=gen, device=dev) < 0.25
    off = torch.where(snap, off.round(), off)
    kernel = torch.randn(c, c // groups, 3, 3, generator=gen, device=dev) * (
        2.0 / (9 * c // groups)) ** 0.5
    weight = deform_conv.pack_weight(kernel, groups, dtype)
    bias = (torch.randn(c, generator=gen, device=dev) * 0.1).to(dtype)
    return x, off, weight, bias


def deform_outside_tolerance(got: torch.Tensor, x, offsets, weight, bias, groups: int):
    """(entries of ``got`` or of the plain version outside the tolerance,
    max |got - plain|) for :func:`~mm_training_tpu_torch.ops.deform_conv.
    deform_conv3x3` on these inputs. The samples are exact (the plain
    columns, bit for bit); the fp32 sums over (tap, C/g) may run in any
    order, which moves a sum by at most 1e-5 of its sum of |terms|. So an
    output is right when it is the op's own rounding of some sum within that
    bound of the exact (float64) sum: the sum rounded to x's dtype, then
    the bias added in x's dtype. Each rounding is monotone, so that is the
    range between the outputs of the two ends of the bound."""
    b, h, w, c = x.shape
    cols = deform_conv.deform_sample_plain(x, offsets).double()
    cols = cols.reshape(b * h * w, 9, groups, c // groups).permute(2, 0, 1, 3)
    cols = cols.reshape(groups, b * h * w, -1)
    wd = weight.double()
    exact = torch.bmm(cols, wd)
    slack = 1e-5 * torch.bmm(cols.abs(), wd.abs())
    bias = bias.to(x.dtype)

    def rounded(s):   # the op's roundings of an fp32 sum s
        s = s.permute(1, 0, 2).reshape(b, h, w, -1).float().to(x.dtype)
        return s + bias
    lo, hi = rounded(exact - slack), rounded(exact + slack)
    plain = deform_conv.deform_conv3x3_plain(x, offsets, weight, bias, groups)
    outside = sum(int(((v < lo) | (v > hi)).sum()) for v in (got, plain))
    return outside, (got.float() - plain.float()).abs().max().item()
