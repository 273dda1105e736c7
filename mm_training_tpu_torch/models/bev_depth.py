"""Top-level BEV detector, LiDAR / LiDAR+radar branch.

The port of ``mm_training_tpu/models/bev_depth.py::BEVDepthLiDAR`` without
the camera branch: the dense pillar encoder feeds the CenterPoint head
directly (the lidar BEV already sits on the head's grid/8 input). The
camera branch and fusion arrive in slice 3, the checkpoint-import
``sparse_import`` encoder in slice 5; both raise until then.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from .. import resolve_device
from ..configs import Config
from .bn_fold import BatchNorm2d
from .centerpoint_head import BEVDepthHead, SeparateHead
from .lidar_encoder import LidarBEVEncoder

__all__ = ['BEVDepthLiDAR', 'init_weights']


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init in place: conv kernels normal with std
    1/sqrt(fan_in) (flax's lecun scale), biases zero except each heatmap's
    final bias (``init_bias``), BatchNorm as a fresh one."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            # fan_in = input channels x taps for both layouts
            # (Conv2d [O, I, kh, kw], ConvTranspose2d [I, O, kh, kw])
            w = m.weight
            cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
            fan_in = cin * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
    for m in model.modules():
        if isinstance(m, SeparateHead) and 'heatmap' in m.head_names:
            m.heatmap[-1].bias.fill_(m.init_bias)


class BEVDepthLiDAR(nn.Module):
    """LiDAR(+radar) pillar encoder + CenterPoint head, built in eval mode.

    Built on ``device`` (default CUDA; raises without a card unless
    ``device='cpu'``) with weights drawn from ``generator`` (default: a CPU
    generator seeded with ``cfg.seed``). Parameters are float32 and 4-D ones
    channels_last; the steps make the bf16 copies when ``cfg.precision ==
    'bf16'``, and activations follow the weights' dtype. ``model.train()``
    switches every BatchNorm to batch statistics, the only layers whose
    behaviour depends on the mode (the JAX modules' ``train`` flag)."""

    def __init__(self, cfg: Config, device=None,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        super().__init__()
        if cfg.use_cam:
            raise NotImplementedError('the camera branch and fusion arrive in '
                                      'slice 3 of the port')
        if not cfg.use_lidar:
            raise ValueError('the lidar slice needs use_lidar=True')
        lconf = cfg.get_lidar_conf()
        if lconf.variant != 'dense':
            raise NotImplementedError(f'lidar encoder variant {lconf.variant!r} '
                                      'arrives in slice 5 (checkpoint import)')
        self.cfg = cfg
        with torch.device('meta'):   # no init work, no global RNG draws
            self.lidar_encoder = LidarBEVEncoder(
                lconf, pc_range=cfg.point_cloud_range,
                voxel_size=cfg.voxel_size, grid_hw=cfg.out_shape)
            self.head = BEVDepthHead(cfg.get_head_conf())
        self.to_empty(device='cpu')
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        init_weights(self, generator)
        self.to(dev, memory_format=torch.channels_last)
        self.eval()

    def forward(self, points: torch.Tensor,
                point_mask: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """points [B, P, F] float32, point_mask [B, P] bool -> list over tasks
        of dicts of NHWC pred maps [B, H/4, W/4, ch] in the weights' dtype
        (float32, or bfloat16 after ``cast_floating``)."""
        dtype = self.head.shared_conv.conv.weight.dtype
        bev = self.lidar_encoder(points, point_mask, dtype)
        return self.head(bev)
