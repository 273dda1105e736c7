"""Frozen copy of the port's ``models/bev_depth.py`` for the benchmark's reference, run
on its plain path (its kernel calls bound to their plain versions, one
process). The text below is the original's.

Top-level multimodal BEV detector.

The port of ``mm_training_tpu/models/bev_depth.py::BEVDepthLiDAR``: the
camera branch (``LSSFPN``, whose BEV the BEV augmentation warps, kernel K7)
and the LiDAR (+radar) encoder the config names (``LidarEncoderConf.
variant``: the dense pillar encoder, or ``'sparse_import'``, the masked-dense
replica of the reference's SparseEncoder whose weights import from its
checkpoints), concatenated ``[camera, lidar]`` on channels and gated by
``BEVFuseLayer``, feed the CenterPoint head. Either branch alone feeds the
head directly. Where the two grids differ, the LiDAR BEV is resized to the
camera BEV's shape (``ops/warp.py::resize_bilinear``, JAX :91-92).

On a model axis (``parallel.make_mesh(model_parallel > 1)``) the model peers
run the encoders and the fusion replicated on the same rows, and the head on
this rank's W range of the fused BEV (``parallel/spatial.py``, JAX :99-102):
the forward returns this rank's W shard of every pred map.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .. import parallel
from ..configs import Config
from ..ops import warp
from ..parallel import spatial
from .bn_fold import BatchNorm2d
from .centerpoint_head import BEVDepthHead, SeparateHead
from .depth_net import DeformConv2d
from .fusion import BEVFuseLayer
from .lidar_encoder import LidarBEVEncoder
from .lss_fpn import LSSFPN

LIDAR_VARIANTS = ('dense',)

__all__ = ['BEVDepthLiDAR', 'init_weights']


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init in place: conv kernels normal with std
    1/sqrt(fan_in) (flax's lecun scale), biases zero except each heatmap's
    final bias (``init_bias``), BatchNorm as a fresh one, the deformable
    conv as the JAX package inits it (He, zero offsets)."""
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
        elif isinstance(m, DeformConv2d):
            m.reset_parameters(generator)


class BEVDepthLiDAR(nn.Module):
    """Camera and/or LiDAR(+radar) branches, fusion and the CenterPoint
    head, built in eval mode.

    Built on ``device`` (default CUDA; raises without a card unless
    ``device='cpu'``) with weights drawn from ``generator`` (default: a CPU
    generator seeded with ``cfg.seed``). Parameters are float32 and 4-D ones
    channels_last; the steps make the bf16 copies when ``cfg.precision ==
    'bf16'``, and activations follow the weights' dtype. ``model.train()``
    switches every BatchNorm to batch statistics, the only layers whose
    behaviour depends on the mode (the JAX modules' ``train`` flag) besides
    ASPP's dropout, whose keep masks a train-mode camera forward takes."""

    def __init__(self, cfg: Config, device=None,
                 generator: Optional[torch.Generator] = None):
        dev = torch.device(device)
        super().__init__()
        if not (cfg.use_cam or cfg.use_lidar):
            raise ValueError('the model needs use_cam or use_lidar')
        lconf = cfg.get_lidar_conf()
        if cfg.use_lidar and lconf.variant not in LIDAR_VARIANTS:
            raise ValueError(f'LidarEncoderConf.variant = {lconf.variant!r}: one of '
                             f'{LIDAR_VARIANTS}')
        self.cfg = cfg
        with torch.device('meta'):   # no init work, no global RNG draws
            if cfg.use_cam:
                self.backbone = LSSFPN(cfg.get_backbone_conf())
            if cfg.use_lidar:
                self.lidar_encoder = LidarBEVEncoder(
                    lconf, pc_range=cfg.point_cloud_range,
                    voxel_size=cfg.voxel_size, grid_hw=cfg.out_shape)
            if cfg.use_cam and cfg.use_lidar:
                self.bev_fuse = BEVFuseLayer(cfg.camera_feature_channels + lconf.out_channels,
                                             cfg.fuse_layer_in_channels)
            self.head = BEVDepthHead(cfg.get_head_conf())
        self.to_empty(device='cpu')
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        init_weights(self, generator)
        self.to(dev, memory_format=torch.channels_last)
        self.eval()

    def forward(self, points: Optional[torch.Tensor] = None,
                point_mask: Optional[torch.Tensor] = None, *,
                imgs: Optional[torch.Tensor] = None,
                sensor2ego: Optional[torch.Tensor] = None,
                intrin: Optional[torch.Tensor] = None,
                bda_mat: Optional[torch.Tensor] = None,
                flipped: Optional[torch.Tensor] = None,
                depth_oracle: Optional[torch.Tensor] = None,
                dropout: Optional[Sequence[torch.Tensor]] = None,
                return_depth: bool = False):
        """-> list over tasks of dicts of NHWC pred maps [B, H/4, W/4, ch]
        in the weights' dtype (float32, or bfloat16 after ``cast_floating``);
        with ``return_depth``, (that list, the key frame's depth [B*N, D, fH,
        fW] or None without the camera): the softmax over the bins as the
        images came (flips not undone), which the depth loss reads (the JAX
        model's second output). Serving leaves it out and holds nothing
        longer.

        LiDAR: points [B, P, F] float32, point_mask [B, P] bool. Camera:
        imgs [B, S, N, H, W, 3] normalised float (cast to the weights'
        dtype here), sensor2ego and intrin [B, S, N, 4, 4] and bda_mat
        [B, 4, 4] float32, flipped [B*S*N] bool or None (no image flipped),
        depth_oracle [B*N, fH, fW, D] float32 or None, dropout (train mode)
        ASPP's keep masks, one [B*N, mid, fH, fW] bool a sweep."""
        dtype = self.head.shared_conv.conv.weight.dtype
        bevs = []
        depth = None
        if self.cfg.use_cam:
            cam, depth = self.backbone(imgs.to(dtype), sensor2ego, intrin, flipped,
                                       depth_oracle, dropout)
            bevs.append(warp.bda_bev_warp(cam, bda_mat).permute(0, 3, 1, 2))
        if self.cfg.use_lidar:
            bevs.append(self.lidar_encoder(points, point_mask, dtype))
        if len(bevs) == 2:
            if bevs[0].shape[2:] != bevs[1].shape[2:]:
                bevs[1] = warp.resize_bilinear(bevs[1], bevs[0].shape[2:])
            fused = self.bev_fuse(torch.cat(bevs, dim=1))
        else:
            fused = bevs[0]
        if fused.dtype != dtype:
            raise TypeError(f'the fused BEV is {fused.dtype}, not the compute dtype {dtype}')
        axis = parallel.model_axis()
        spatial.check_columns(fused.shape[-1], self.head.total_stride, axis)
        preds = self.head(spatial.shard_w(fused, axis), axis)
        return (preds, depth) if return_depth else preds
