"""Frozen copy of the port's ``models/second_fpn.py`` for the benchmark's reference, run
on its plain path (its kernel calls bound to their plain versions, one
process). The text below is the original's.

SECONDFPN neck (NCHW, channels_last memory).

The port of ``mm_training_tpu/models/second_fpn.py``. Per level: stride >= 1
is a ConvTranspose2d with kernel == stride (the JAX ``Upsample`` computes the
same map as an einsum over the spatially reversed kernel), stride < 1 a
strided Conv2d; each is followed by BN + ReLU (kernel A) and the levels are
concatenated on channels. mmdet3d naming: ``deblocks.{i}.0`` (conv),
``deblocks.{i}.1`` (BN).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .bn_fold import BatchNorm2d

__all__ = ['SECONDFPN']


class SECONDFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int],
                 upsample_strides: Sequence[float]):
        super().__init__()
        if not len(in_channels) == len(out_channels) == len(upsample_strides):
            raise ValueError('SECONDFPN: one in/out channel count and one '
                             'stride per level')
        blocks = []
        for cin, cout, us in zip(in_channels, out_channels, upsample_strides):
            if us >= 1:
                s = int(round(us))
                up = nn.ConvTranspose2d(cin, cout, s, stride=s, bias=False)
            else:
                s = int(round(1 / us))
                up = nn.Conv2d(cin, cout, s, stride=s, bias=False)
            blocks.append(nn.Sequential(up, BatchNorm2d(cout, relu=True)))
        self.deblocks = nn.ModuleList(blocks)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([blk(x) for blk, x in zip(self.deblocks, feats)], dim=1)
