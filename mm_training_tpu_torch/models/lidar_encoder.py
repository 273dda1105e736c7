"""LiDAR/radar pillar BEV encoder (the dense variant).

The port of ``mm_training_tpu/models/lidar_encoder.py::LidarBEVEncoder``:
kernel K1 (``ops/voxelize.py::pillar_encoder_input``, one launch) writes the
per-pillar mean of the first ``num_features`` point features in the compute
dtype, folded by the 2x2 space-to-depth entry to half resolution
([B, ny/2, nx/2, 4F]), and a conv pyramid with the SparseEncoder's channel
progression reaches total stride 8 and the 256-channel BEV contract. The
first conv's input channels may be padded with zeros
(``INPUT_CHANNEL_MULTIPLE``): K1 writes the zero channels and the conv
takes its kernel padded with zeros at call time, so the parameter keeps
the reference's shape and the sums are the same.
Module names mirror the flax scopes (``stage{si}_conv{ci}``, ``out_conv``);
this encoder has no reference checkpoint counterpart.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import LidarEncoderConf
from ..ops import voxelize
from .bn_fold import StateCache
from .resnet import ConvBN

__all__ = ['LidarBEVEncoder', 'padded_input_weight']


def padded_input_weight(w: torch.Tensor, channels: int, cache: StateCache) -> torch.Tensor:
    """A conv kernel [C_out, C_in, kh, kw] with zero input channels up to
    ``channels`` (``w`` itself when there are none); without a gradient to
    carry, padded once per state of ``w`` (``cache``)."""
    pad = channels - w.shape[1]
    if pad == 0:
        return w

    def make():
        return F.pad(w, (0, 0, 0, 0, 0, pad)).contiguous(memory_format=torch.channels_last)
    if torch.is_grad_enabled() and w.requires_grad:
        return make()
    return cache.get((w,), channels, make)


class LidarBEVEncoder(nn.Module):
    # the first conv's input channels, padded with zeros to a multiple of
    # this: cuDNN runs the bf16 3x3 conv at [4, C, 128, 1024] 2.2x faster
    # forward and backward at C = 32 than at the 20 of the space-to-depth
    # (``exps/profile_convs.py --lidar-stem``, PERF.md)
    INPUT_CHANNEL_MULTIPLE = 16

    def __init__(self, conf: LidarEncoderConf, pc_range: Sequence[float],
                 voxel_size: Sequence[float], grid_hw: Tuple[int, int]):
        super().__init__()
        self.conf = conf
        self.pc_range = tuple(pc_range)
        self.voxel_size = tuple(voxel_size)
        self.grid_hw = tuple(grid_hw)
        s2d = conf.space_to_depth
        cin = conf.voxelization.num_features * (4 if s2d else 1)
        m = self.INPUT_CHANNEL_MULTIPLE
        self.input_channels = -(-cin // m) * m
        self._padded = StateCache()   # the first conv's kernel padded to input_channels
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

    def first_conv_weight(self) -> torch.Tensor:
        """The first conv's kernel [C_out, input_channels, 3, 3], zero past
        its own input channels (:func:`padded_input_weight`)."""
        return padded_input_weight(getattr(self, self.conv_names[0]).conv.weight,
                                   self.input_channels, self._padded)

    def forward(self, points: torch.Tensor, point_mask: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """points [B, P, F] float32, point_mask [B, P] bool ->
        BEV [B, 256, ny/8, nx/8] (channels_last) in ``compute_dtype``.
        Voxelization stays float32 (0.2 m cells at 200 m range); one
        rounding to ``compute_dtype`` after the mean."""
        x = voxelize.pillar_encoder_input(
            points, point_mask, self.pc_range, self.voxel_size, self.grid_hw,
            num_features=self.conf.voxelization.num_features, dtype=compute_dtype,
            space_to_depth=self.conf.space_to_depth, channels=self.input_channels)
        x = x.permute(0, 3, 1, 2)                     # NCHW view, channels_last
        first = getattr(self, self.conv_names[0])
        c = first.conv
        x = first.bn(F.conv2d(x, self.first_conv_weight(), c.bias, c.stride, c.padding))
        for name in self.conv_names[1:]:
            x = getattr(self, name)(x)
        return self.out_conv(x)
