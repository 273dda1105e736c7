"""Model FLOPs of a step, counted from the shapes that the configuration
runs, read off the reference model's layers as it runs them.

Counted: every convolution and transposed convolution (2 x multiply-adds),
the deformable conv's grouped product (2 x B x H x W x 9 x C_in/g x
C_out), and the camera's lift-splat contraction (2 x M x D x fH x fW x C,
from the configuration). A training step adds the backward: the weight
gradient of each product, and the input gradient where the input carries a
gradient (not the images' nor the LiDAR grid's first conv). Nothing is
counted twice for being recomputed; elementwise work, BatchNorm statistics
and the decode are not counted. ``tests/test_bench_roofline.py`` holds the
count to ``torch.utils.flop_counter.FlopCounterMode`` over the reference.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn


class LayerLog:
    """Forward hooks on a reference model's products and BatchNorms; each
    call is logged once while ``active``.

    ``products``: (forward FLOPs, input carries a gradient) a call;
    ``norms``: (elements, with a residual) a BatchNorm call."""

    def __init__(self, model: nn.Module):
        self.active = False
        self.products: List[Tuple[float, bool]] = []
        self.norms: List[Tuple[int, bool]] = []
        self.deform_flops = 0.0
        self._handles = []
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                self._handles.append(m.register_forward_hook(self._conv))
            elif type(m).__name__ == 'DeformConv2d':
                self._handles.append(m.register_forward_hook(self._deform))
            elif isinstance(m, nn.BatchNorm2d):
                self._handles.append(m.register_forward_hook(self._norm))

    def _conv(self, m, args, out):
        if not self.active:
            return
        x = args[0]
        kh, kw = m.kernel_size
        if isinstance(m, nn.ConvTranspose2d):
            macs = x.numel() * (m.out_channels // m.groups) * kh * kw
        else:
            macs = out.numel() * (m.in_channels // m.groups) * kh * kw
        self.products.append((2.0 * macs, x.requires_grad))

    def _deform(self, m, args, out):
        if not self.active:
            return
        x = args[0]
        b, c, h, w = x.shape
        flops = 2.0 * b * h * w * 9 * (c // m.groups) * m.weight.shape[0]
        self.products.append((flops, x.requires_grad))
        self.deform_flops += flops

    def _norm(self, m, args, out):
        if self.active:
            residual = len(args) > 1 and args[1] is not None
            self.norms.append((args[0].numel(), residual))

    def remove(self):
        for h in self._handles:
            h.remove()


def splat_flops(cfg, batch: int) -> float:
    """The lift-splat contraction of a forward: 2 x M x D x fH x fW x C."""
    if not cfg.use_cam:
        return 0.0
    bb = cfg.get_backbone_conf()
    fh, fw = bb.feat_hw
    m = batch * cfg.num_sweeps * cfg.num_cameras
    return 2.0 * m * bb.depth_channels * fh * fw * bb.output_channels


def step_flops(log: LayerLog, cfg, batch: int, train: bool) -> float:
    """Model FLOPs of one step from a forward's log."""
    fwd = sum(f for f, _ in log.products) + splat_flops(cfg, batch)
    if not train:
        return fwd
    # weight gradients of every product, input gradients where one flows;
    # the splat's inputs (depth, context) both carry gradients
    dgrad = sum(f for f, g in log.products if g) + splat_flops(cfg, batch)
    return 2 * fwd + dgrad
