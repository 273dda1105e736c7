"""Kernel K4's inputs at a camera config's shapes, laid out as the path hands
them over (``models/lss_fpn.py``). Shared by ``chip_smoke.py``, the card
tests and ``exps/ab_kernels.py``."""
from __future__ import annotations

import numpy as np
import torch

from ..configs import Config
from ..data import make_fake_batch
from ..models.lss_fpn import LSSFPN

__all__ = ['SPLAT_LAYOUTS', 'splat_inputs']

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
