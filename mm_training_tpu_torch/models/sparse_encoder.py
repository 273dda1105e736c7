"""The sparse-import LiDAR encoder: a masked-dense replica of mmdet3d's
spconv ``SparseEncoder`` whose weights import from the reference's
checkpoints.

The port of ``mm_training_tpu/models/sparse_encoder.py::ImportSparseEncoder``
(:122-177), whose docstring proves the reduction: on the reference geometry
every occupied voxel sits on one z-plane, so a submanifold sparse conv is a
dense 3x3 conv on the zero-filled pillar grid masked to the active pillars,
a strided sparse conv a dense strided conv masked to the dilated set (a 3x3
/2 max-pool of the mask), each 3D kernel one z-slice of itself, and the
final ``dense().view(N, C*D, H, W)`` the features interleaved with zeros
per channel (BEV channel 2c is feature c, 2c + 1 is 0; downstream layers
were trained on that order).

Per call: kernel K1's sparse-input mode (``ops/voxelize.py::
sparse_encoder_input``: the first-K point cap, the per-pillar means in the
compute dtype padded to :attr:`ImportSparseEncoder.input_channels`, the
occupancy) -> ``conv_input`` -> four stages of masked BasicBlocks with a
strided conv between them -> ``conv_out`` (a 1x1 conv to
``out_channels // 2``) -> the interleave. Every conv is bias-free; every BN
is a :class:`~mm_training_tpu_torch.models.bn_fold.MaskedBatchNorm2d`, whose
tail ``relu((x*s + t) * mask [+ residual])`` runs through kernel A's masked
form and whose train-mode statistics cover the active pillars only.

Parameters are the z-slice 2-D kernels (OIHW), as the JAX tree stores them,
under the reference's mmdet3d names below ``pts_middle_encoder``:
``conv_input.0`` / ``.1``, ``encoder_layers.encoder_layer{i}.{j}.conv1`` /
``bn1`` / ``conv2`` / ``bn2``, the strided ``encoder_layers.encoder_layer{i}
.{last}.0`` / ``.1``, ``conv_out.0`` / ``.1``; ``models/torch_import.py``
and ``models/torch_export.py`` carry the spconv [kd, kh, kw, I, O] kernels
to and from them.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import LidarEncoderConf
from ..ops import voxelize
from .bn_fold import MaskedBatchNorm2d, StateCache
from .lidar_encoder import padded_input_weight

__all__ = ['ImportSparseEncoder', 'SparseBasicBlock', 'SparseConvModule', 'SparseEncoder',
           'dilate_stride2']


def dilate_stride2(mask: torch.Tensor) -> torch.Tensor:
    """Active set of a 3x3/stride-2/pad-1 regular sparse conv: a 3x3/2
    max-pool of the [N, 1, H, W] bool mask (JAX ``_dilate_stride2``)."""
    return F.max_pool2d(mask.to(torch.float32), 3, 2, 1) > 0


class SparseConvModule(nn.Sequential):
    """One mmdet3d ``make_sparse_convmodule`` unit: ``0`` a bias-free conv,
    ``1`` a masked BN + ReLU (JAX ``_MaskedConvBN``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__(nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False),
                         MaskedBatchNorm2d(cout))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``mask``: the active set at the conv's output resolution."""
        return self[1](self[0](x), mask)


class SparseBasicBlock(nn.Module):
    """mmdet3d ``SparseBasicBlock`` as a masked dense block (JAX
    ``_SparseBasicBlockDense``): two submanifold 3x3 convs, the residual
    added inside the second BN's tail (the input is zero outside the mask
    already)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, 1, 1, bias=False)
        self.bn1 = MaskedBatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = MaskedBatchNorm2d(cout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        out = self.bn1(self.conv1(x), mask)
        return self.bn2(self.conv2(out), mask, x)


class SparseEncoder(nn.Module):
    """The middle encoder (``pts_middle_encoder``): ``conv_input``, the
    stages under ``encoder_layers``, ``conv_out`` and the channel
    interleave; ``forward(x, occ)`` takes the pillar grid [B, C, ny, nx]
    (zero at inactive pillars, C at least the configured input channels:
    the first conv's kernel is padded with zeros to it) and the occupancy
    [B, 1, ny, nx] bool, and returns [B, 2 * (out_channels // 2), ny/8,
    nx/8] (channels_last) in x's dtype."""

    def __init__(self, conf: LidarEncoderConf):
        super().__init__()
        chs = conf.encoder_channels
        self.conv_input = SparseConvModule(conf.in_channels, chs[0][0])
        self._padded = StateCache()   # conv_input's kernel padded to the grid's channels
        self.encoder_layers = nn.Module()
        cin = chs[0][0]
        self.stage_downs = []
        for si, stage in enumerate(chs):
            has_down = si < len(chs) - 1
            layers = []
            for j in range(len(stage) - int(has_down)):
                layers.append(SparseBasicBlock(cin, stage[j]))
                cin = stage[j]
            if has_down:
                layers.append(SparseConvModule(cin, stage[-1], 3, 2))
                cin = stage[-1]
            self.encoder_layers.add_module(f'encoder_layer{si + 1}', nn.ModuleList(layers))
            self.stage_downs.append(has_down)
        self.conv_out = SparseConvModule(cin, conf.out_channels // 2, kernel=1)

    def forward(self, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        mask = occ
        conv, bn = self.conv_input
        w = padded_input_weight(conv.weight, x.shape[1], self._padded)
        x = bn(F.conv2d(x, w, None, 1, 1), mask)
        for si, has_down in enumerate(self.stage_downs):
            layers = getattr(self.encoder_layers, f'encoder_layer{si + 1}')
            for block in layers[:len(layers) - int(has_down)]:
                x = block(x, mask)
            if has_down:
                mask = dilate_stride2(mask)
                x = layers[-1](x, mask)
        x = self.conv_out(x, mask)
        # dense().view(N, C * D, H, W) with D = 2 and plane 1 inactive:
        # channel 2c = feature c, 2c + 1 = 0
        b, c, h, w = x.shape
        out = torch.stack([x, torch.zeros_like(x)], dim=2).reshape(b, 2 * c, h, w)
        return out.contiguous(memory_format=torch.channels_last)


class ImportSparseEncoder(nn.Module):
    """Drop-in LiDAR encoder with the reference's SparseEncoder weights
    (the JAX ``ImportSparseEncoder``): ``forward(points, point_mask,
    compute_dtype)`` -> BEV [B, out_channels, ny/8, nx/8] (channels_last)
    in ``compute_dtype``, as :class:`~mm_training_tpu_torch.models.
    lidar_encoder.LidarBEVEncoder` returns it. Each pillar averages its
    first ``voxelization.max_num_points`` points in input order, mmdet3d's
    hard voxelizer (the JAX module's default ``exact_point_cap``, the only
    setting its model builds)."""

    # the grid's channels, the features padded with zeros to a multiple of
    # this (K1 writes the zeros, conv_input's kernel is padded at call time):
    # cuDNN runs conv_input (3x3, 16 out) at [4, C, 256, 2048] bf16 in 0.217
    # ms forward at C = 16, 0.390 at C = 5 and 1.439 at C = 8
    # (``exps/profile_convs.py --sparse-stem``, PERF.md)
    INPUT_CHANNEL_MULTIPLE = 16

    def __init__(self, conf: LidarEncoderConf, pc_range: Sequence[float],
                 voxel_size: Sequence[float], grid_hw: Tuple[int, int]):
        super().__init__()
        self.conf = conf
        self.pc_range = tuple(pc_range)
        self.voxel_size = tuple(voxel_size)
        self.grid_hw = tuple(grid_hw)
        m = self.INPUT_CHANNEL_MULTIPLE
        self.input_channels = -(-conf.voxelization.num_features // m) * m
        self.pts_middle_encoder = SparseEncoder(conf)

    def voxelize(self, points: torch.Tensor, point_mask: torch.Tensor,
                 compute_dtype: torch.dtype = torch.float32):
        """(grid [B, input_channels, ny, nx] NCHW view of K1's channels-last
        output in ``compute_dtype``, occupancy [B, 1, ny, nx] bool)."""
        vconf = self.conf.voxelization
        grid, occ = voxelize.sparse_encoder_input(
            points, point_mask, self.pc_range, self.voxel_size, self.grid_hw,
            num_features=vconf.num_features, dtype=compute_dtype,
            channels=self.input_channels, max_points_per_voxel=vconf.max_num_points)
        return grid.permute(0, 3, 1, 2), occ

    def forward(self, points: torch.Tensor, point_mask: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """points [B, P, F] float32 (voxelized in float32), point_mask [B, P]
        bool."""
        return self.pts_middle_encoder(*self.voxelize(points, point_mask, compute_dtype))
