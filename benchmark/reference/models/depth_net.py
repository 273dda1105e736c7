"""Frozen copy of the port's ``models/depth_net.py`` for the benchmark's reference, run
on its plain path (its kernel calls bound to their plain versions, one
process). The text below is the original's.

DepthNet, ASPP and the deformable conv of the camera branch (NCHW,
channels_last memory).

The port of ``mm_training_tpu/models/depth_net.py``: ``DeformConv2d``
(:30-110), ``ASPP`` (:113-134) and ``DepthNet`` (:137-165). The reduce conv
feeds a 1x1 context conv and, in parallel, a depth branch of BasicBlocks,
ASPP (dilations 1/6/12/18 and a global-mean branch), the deformable 3x3 conv
and a 1x1 conv to the depth bins; the output is the depth logits first and
the context after. Every BatchNorm tail runs through kernel A; the
deformable conv after its offset conv is kernel K5 (``ops/deform_conv.py``,
one fused launch); ASPP's widest dilations run as phase sub-images
(``AtrousConv2d``). Names are the reference's (``reduce_conv.0``/``.1``,
``context_conv``, ``depth_conv.{0..5}``, ASPP's ``aspp{i}.atrous_conv``/
``.bn``, ``global_avg_pool.1``/``.2``, ``conv1``/``bn1``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import deform_conv
from .bn_fold import BatchNorm2d, StateCache
from .resnet import BasicBlock

__all__ = ['ASPP', 'AtrousConv2d', 'DeformConv2d', 'DepthNet', 'Dropout', 'phase_split_conv3x3']


class DeformConv2d(nn.Module):
    """Deformable 3x3 conv (DCNv1, one deform group, ``groups`` conv
    groups) with the JAX parametrization: mmcv's ``weight`` [C_out,
    C_in/groups, 3, 3] (no conv bias in mmcv) plus the JAX module's
    ``bias``, added after the grouped product. ``conv_offset`` predicts the
    (dy, dx) of each tap; it is zero-initialised in the JAX package, which
    makes a fresh DCN a plain 3x3 conv.

    The offsets are float32 (the offset conv stays cuDNN's); the fused
    kernel K5 (``ops/deform_conv.py::deform_conv3x3``) samples the nine taps
    and contracts them with the kernel over (tap, C_in/g) for each group
    (float32 sums, one rounding, then the bias), with no column tensor."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 4):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError(f'DeformConv2d: {in_channels} -> {out_channels} channels '
                             f'do not split into {groups} groups')
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, 3, 3))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.conv_offset = nn.Conv2d(in_channels, 18, 3, padding=1)
        self._packed = StateCache()   # the kernel laid out for the fused op

    def reset_parameters(self, generator: torch.Generator) -> None:
        """He init over the true per-group fan-in 9 * C_in/g (the JAX
        init's variance), zero bias, zero offset conv."""
        fan_in = self.weight.shape[1] * 9
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=generator)
                              * math.sqrt(2.0 / fan_in))
            self.bias.zero_()
            self.conv_offset.weight.zero_()
            self.conv_offset.bias.zero_()

    def packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The kernel as the fused op reads it, [g, 9 * C_in/g, C_out/g] in
        ``dtype`` (``ops/deform_conv.py::pack_weight``). Without a gradient
        to carry it is laid out once per state of the parameter, not per
        call, as ``bn_fold.BatchNorm2d`` caches its scale and shift."""
        def make():
            return deform_conv.pack_weight(self.weight, self.groups, dtype)
        if torch.is_grad_enabled() and self.weight.requires_grad:
            return make()
        return self._packed.get((self.weight,), dtype, make)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        offsets = self.conv_offset(x).permute(0, 2, 3, 1).float()      # [B, H, W, 18]
        out = deform_conv.deform_conv3x3(x.permute(0, 2, 3, 1), offsets,
                                         self.packed_weight(x.dtype), self.bias.to(x.dtype),
                                         self.groups)                    # [B, H, W, C_out]
        return out.permute(0, 3, 1, 2)


def phase_split_conv3x3(x: torch.Tensor, weight: torch.Tensor, dilation: int) -> torch.Tensor:
    """A 3x3 conv at ``dilation`` (padding = dilation, no bias) as a plain
    3x3 conv (padding 1) over the dilation x dilation phase sub-images of x,
    the space-to-batch form of an atrous conv: the image is zero-padded to
    multiples of the dilation at its far edges, which reads as the conv's
    zero padding. The same products as the dilated conv, summed in fp32 in
    another order. NCHW in and out, channels_last memory."""
    n, c, h, w = x.shape
    d = dilation
    hp, wp = -(-h // d) * d, -(-w // d) * d
    xh = F.pad(x.permute(0, 2, 3, 1), (0, 0, 0, wp - w, 0, hp - h))          # NHWC
    xs = xh.reshape(n, hp // d, d, wp // d, d, c).permute(0, 2, 4, 1, 3, 5)
    xs = xs.reshape(n * d * d, hp // d, wp // d, c).permute(0, 3, 1, 2)    # channels_last
    y = F.conv2d(xs, weight, None, 1, 1).permute(0, 2, 3, 1)
    o = weight.shape[0]
    y = y.reshape(n, d, d, hp // d, wp // d, o).permute(0, 3, 1, 4, 2, 5).reshape(n, hp, wp, o)
    return y[:, :h, :w].permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class AtrousConv2d(nn.Conv2d):
    """ASPP's 3x3 conv at ``dilation`` (padding = dilation, no bias). From
    dilation ``PHASE_SPLIT_FROM`` on it runs as
    :func:`phase_split_conv3x3`: cuDNN has no tensor-core kernel for the
    bf16 channels_last conv at ASPP's dilations 12 and 18 on the H100 and
    falls back to a direct kernel about 300 times slower than the same conv
    as phase sub-images (PERF.md, ``exps/profile_convs.py``)."""
    PHASE_SPLIT_FROM = 12

    def __init__(self, cin: int, cout: int, dilation: int):
        super().__init__(cin, cout, 3, padding=dilation, dilation=dilation, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dilation[0]
        if d < self.PHASE_SPLIT_FROM:
            return super().forward(x)
        return phase_split_conv3x3(x, self.weight, d)


class _ASPPModule(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, dilation: int):
        super().__init__()
        self.atrous_conv = (AtrousConv2d(cin, cout, dilation) if kernel == 3 else
                            nn.Conv2d(cin, cout, kernel, bias=False))
        self.bn = BatchNorm2d(cout, relu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.atrous_conv(x))


class Dropout(nn.Module):
    """flax's ``nn.Dropout(rate)`` with the keep mask as an input, not a
    draw from a global generator: in train mode ``where(keep, x / (1 -
    rate), 0)`` elementwise, ``keep`` a bool tensor of x's shape (keep
    probability 1 - rate; the caller draws it, from a ``torch.Generator``
    it owns or as the JAX package drew it); in eval mode x itself."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, keep=None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if keep is None or keep.shape != x.shape or keep.dtype != torch.bool:
            raise ValueError(f'Dropout in train mode takes a bool keep mask of the input\'s '
                             f'shape {tuple(x.shape)}, got '
                             f'{None if keep is None else (tuple(keep.shape), keep.dtype)}')
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: 1x1 and dilated 3x3 (6, 12, 18)
    ConvBN-ReLUs and a global-mean ConvBN-ReLU, concatenated, a 1x1
    ConvBN-ReLU and dropout 0.5 (off in eval; in train mode its keep mask
    [B, mid, H, W] is an input, :class:`Dropout`)."""

    def __init__(self, in_channels: int, mid_channels: int):
        super().__init__()
        self.aspp1 = _ASPPModule(in_channels, mid_channels, 1, 1)
        self.aspp2 = _ASPPModule(in_channels, mid_channels, 3, 6)
        self.aspp3 = _ASPPModule(in_channels, mid_channels, 3, 12)
        self.aspp4 = _ASPPModule(in_channels, mid_channels, 3, 18)
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(in_channels, mid_channels, 1, bias=False),
            BatchNorm2d(mid_channels, relu=True))
        self.conv1 = nn.Conv2d(5 * mid_channels, mid_channels, 1, bias=False)
        self.bn1 = BatchNorm2d(mid_channels, relu=True)
        self.dropout = Dropout(0.5)

    def forward(self, x: torch.Tensor, keep=None) -> torch.Tensor:
        x4 = self.aspp4(x)
        pooled = self.global_avg_pool(x).expand(-1, -1, *x4.shape[2:])
        out = torch.cat([self.aspp1(x), self.aspp2(x), self.aspp3(x), x4, pooled], dim=1)
        return self.dropout(self.bn1(self.conv1(out)), keep)


class DepthNet(nn.Module):
    """Depth and context head: [B, C_in, fH, fW] -> [B, D + C_ctx, fH, fW],
    the depth logits first, the context after. ``use_dcn=False`` leaves
    ``depth_conv.4`` an identity, so the names stay the reference's. In
    train mode ``forward`` takes ASPP's dropout keep mask [B, mid, fH,
    fW]."""

    def __init__(self, in_channels: int, mid_channels: int, context_channels: int,
                 depth_channels: int, use_dcn: bool = True, num_blocks: int = 3):
        super().__init__()
        self.reduce_conv = nn.Sequential(
            nn.Conv2d(in_channels, mid_channels, 3, padding=1),   # the reference's bias
            BatchNorm2d(mid_channels, relu=True))
        self.context_conv = nn.Conv2d(mid_channels, context_channels, 1)
        self.depth_conv = nn.Sequential(
            *(BasicBlock(mid_channels, mid_channels) for _ in range(num_blocks)),
            ASPP(mid_channels, mid_channels),
            DeformConv2d(mid_channels, mid_channels, groups=4) if use_dcn else nn.Identity(),
            nn.Conv2d(mid_channels, depth_channels, 1))

    def forward(self, x: torch.Tensor, keep=None) -> torch.Tensor:
        x = self.reduce_conv(x)
        d = x
        for layer in self.depth_conv:
            d = layer(d, keep) if isinstance(layer, ASPP) else layer(d)
        return torch.cat([d, self.context_conv(x)], dim=1)
