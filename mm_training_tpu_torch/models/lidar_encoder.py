"""LiDAR/radar pillar BEV encoder (the dense variant).

The port of ``mm_training_tpu/models/lidar_encoder.py::LidarBEVEncoder``:
kernel K1 scatters the per-pillar mean of the first ``num_features`` point
features into a dense [B, ny, nx, F] grid, a 2x2 space-to-depth entry folds
it to half resolution, and a conv pyramid with the SparseEncoder's channel
progression reaches total stride 8 and the 256-channel BEV contract.
Module names mirror the flax scopes (``stage{si}_conv{ci}``, ``out_conv``);
this encoder has no reference checkpoint counterpart.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..configs import LidarEncoderConf
from ..ops import voxelize
from .resnet import ConvBN, space_to_depth_2x2

__all__ = ['LidarBEVEncoder']


class LidarBEVEncoder(nn.Module):
    def __init__(self, conf: LidarEncoderConf, pc_range: Sequence[float],
                 voxel_size: Sequence[float], grid_hw: Tuple[int, int]):
        super().__init__()
        self.conf = conf
        self.pc_range = tuple(pc_range)
        self.voxel_size = tuple(voxel_size)
        self.grid_hw = tuple(grid_hw)
        s2d = conf.space_to_depth
        cin = conf.voxelization.num_features * (4 if s2d else 1)
        self.conv_names = []
        for si, stage in enumerate(conf.encoder_channels):
            for ci, ch in enumerate(stage):
                # total stride /8: without s2d the first conv of stages 1..3
                # strides; with the /2 s2d entry only stages 1 and 2 do
                if s2d:
                    stride = 2 if (ci == 0 and 1 <= si <= 2) else 1
                else:
                    stride = 2 if (si > 0 and ci == 0) else 1
                name = f'stage{si}_conv{ci}'
                self.add_module(name, ConvBN(cin, ch, 3, stride))
                self.conv_names.append(name)
                cin = ch
        self.out_conv = ConvBN(cin, conf.out_channels, 3)

    def forward(self, points: torch.Tensor, point_mask: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """points [B, P, F] float32, point_mask [B, P] bool ->
        BEV [B, 256, ny/8, nx/8] (channels_last) in ``compute_dtype``.
        Voxelization stays float32 (0.2 m cells at 200 m range)."""
        x = voxelize.voxelize_pillars_dense(
            points, point_mask, self.pc_range, self.voxel_size, self.grid_hw,
            num_features=self.conf.voxelization.num_features)
        x = x.to(compute_dtype)                       # [B, ny, nx, F] NHWC
        if self.conf.space_to_depth:
            x = space_to_depth_2x2(x)
        x = x.permute(0, 3, 1, 2)                     # NCHW view, channels_last
        for name in self.conv_names:
            x = getattr(self, name)(x)
        return self.out_conv(x)
