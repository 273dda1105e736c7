"""Frozen copy of the port's ``models/resnet.py`` for the benchmark's reference, run
on its plain path (its kernel calls bound to their plain versions, one
process). The text below is the original's.

ResNets of the BEV head trunk and the image backbone (NCHW, channels_last).

The port of ``mm_training_tpu/models/resnet.py``: ``ConvBN``,
``BasicBlock``, ``Bottleneck`` (:70-87), the mmdet-style ``ResNet`` at
depths 10, 18, 34, 50 and 101, and ``space_to_depth_2x2``. Module and
parameter names are mmdet's (``conv1``/``bn1``, ``layer{i}.{j}.conv1``,
``downsample.0``/``.1``), so a reference state dict loads as is. Every
BatchNorm tail (with its ReLU and, in a block, the residual add) runs
through kernel A.

On a model axis (``parallel/spatial.py``) the BEV head's trunk runs on a W
shard: each module's ``forward`` takes the rank's ``axis``, and every conv
and the stem's max-pool read their halo from the neighbouring shards. With
``axis`` None (the image backbone, a run without a model axis) they are the
plain modules.

The stem is the reference's 7x7/2 conv. The JAX image backbone runs the
same map as its exact space-to-depth form (``_S2DStem``, a masked 4x4 conv
on the 2x2-blocked image); ``models/weights.py`` turns that kernel back into
the 7x7 one (``stem_7x7_from_s2d``), so the port needs no second stem.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from ..parallel import spatial
from .bn_fold import BatchNorm2d

__all__ = ['ConvBN', 'BasicBlock', 'Bottleneck', 'DEPTH_CFG', 'ResNet', 'space_to_depth_2x2']


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, padding=kernel // 2, bias=bias)


class ConvBN(nn.Module):
    """conv -> BN (-> ReLU); mmcv ConvModule naming (``conv``, ``bn``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 relu: bool = True, conv_bias: bool = False):
        super().__init__()
        self.conv = _conv(cin, cout, kernel, stride, conv_bias)
        self.bn = BatchNorm2d(cout, relu=relu)

    def forward(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        return self.bn(spatial.conv2d(self.conv, x, axis))


class BasicBlock(nn.Module):
    """mmdet BasicBlock (expansion 1): relu(bn2(conv2(relu(bn1(conv1 x))))
    + identity), the add and the last ReLU inside bn2's kernel."""
    expansion = 1

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride)
        self.bn1 = BatchNorm2d(cout, relu=True)
        self.conv2 = _conv(cout, cout, 3)
        self.bn2 = BatchNorm2d(cout, relu=True)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride),
                                            BatchNorm2d(cout, relu=False))

    def forward(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        out = self.bn1(spatial.conv2d(self.conv1, x, axis))
        # a 1x1 (strided) conv reads no column beyond a stride-aligned shard
        identity = x if self.downsample is None else self.downsample(x)
        return self.bn2(spatial.conv2d(self.conv2, out, axis), identity)


class Bottleneck(nn.Module):
    """mmdet Bottleneck (expansion 4, stride on the 3x3): relu(bn3(conv3(
    relu(bn2(conv2(relu(bn1(conv1 x))))))) + identity), the add and the last
    ReLU inside bn3's kernel. ``width`` is the bottleneck width."""
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = BatchNorm2d(width, relu=True)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = BatchNorm2d(width, relu=True)
        self.conv3 = _conv(width, cout, 1)
        self.bn3 = BatchNorm2d(cout, relu=True)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride),
                                            BatchNorm2d(cout, relu=False))

    def forward(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        out = self.bn2(spatial.conv2d(self.conv2, self.bn1(self.conv1(x)), axis))
        identity = x if self.downsample is None else self.downsample(x)
        return self.bn3(self.conv3(out), identity)


DEPTH_CFG = {
    10: (BasicBlock, (1, 1, 1, 1)),   # the JAX package's smoke tier
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
}


class ResNet(nn.Module):
    """mmdet-style ResNet returning multi-scale features.

    Stem: 7x7/2 conv + BN + ReLU + 3x3/2 max-pool (padding acts as -inf), so
    stage i sits at total stride 4 * prod(strides[:i + 1])."""

    def __init__(self, depth: int = 18, in_channels: int = 3,
                 base_channels: int = 64, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 out_indices: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        if depth not in DEPTH_CFG:
            raise ValueError(f'ResNet-{depth}: depths {sorted(DEPTH_CFG)}')
        block, stage_blocks = DEPTH_CFG[depth]
        self.out_indices = tuple(out_indices)
        # the last stage's stride: the stem's 4 times the stages'
        self.total_stride = 4 * math.prod(strides[:num_stages])
        self.conv1 = _conv(in_channels, base_channels, 7, 2)
        self.bn1 = BatchNorm2d(base_channels, relu=True)
        cin, width = base_channels, base_channels
        self.stage_names = []
        for i in range(num_stages):
            blocks = []
            for j in range(stage_blocks[i]):
                blocks.append(block(cin, width, strides[i] if j == 0 else 1))
                cin = width * block.expansion
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))
            self.stage_names.append(f'layer{i + 1}')
            width *= 2

    def forward(self, x: torch.Tensor, axis=None) -> Tuple[torch.Tensor, ...]:
        x = self.bn1(spatial.conv2d(self.conv1, x, axis))
        x = spatial.max_pool2d(x, 3, 2, 1, axis)
        outs = []
        for i, name in enumerate(self.stage_names):
            for block in getattr(self, name):
                x = block(x, axis)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


def space_to_depth_2x2(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, H/2, W/2, 4C]; the channel-group order is
    (row-offset, col-offset) minor, as in the JAX package."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f'space_to_depth_2x2 needs even H and W, got {(h, w)}')
    xb = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return xb.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
