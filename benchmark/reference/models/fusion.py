"""Frozen copy of the port's ``models/fusion.py`` for the benchmark's reference, run
on its plain path (its kernel calls bound to their plain versions, one
process). The text below is the original's.

BEV fusion layer (NCHW, channels_last memory).

The port of ``mm_training_tpu/models/fusion.py::BEVFuseLayer`` (the
reference's, models/bev_depth.py:133-145): a 3x3 conv, the global mean, a
1x1 conv and a sigmoid channel gate. No BatchNorm. The flax convs take
whatever channels arrive and emit ``cfg.fuse_layer_in_channels``; the port
names both counts (equal at the released widths).
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ['BEVFuseLayer']


class BEVFuseLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_3 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.conv_1 = nn.Conv2d(out_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_3(x)
        return x * torch.sigmoid(self.conv_1(x.mean(dim=(2, 3), keepdim=True)))
