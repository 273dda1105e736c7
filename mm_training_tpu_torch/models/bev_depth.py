"""Top-level multimodal BEV detector.

The port of ``mm_training_tpu/models/bev_depth.py::BEVDepthLiDAR``: the
camera branch (``LSSFPN``, whose BEV the BEV augmentation warps, kernel K7)
and the LiDAR (+radar) encoder the config names (``LidarEncoderConf.
variant``: the dense pillar encoder, or ``'sparse_import'``, the masked-dense
replica of the reference's SparseEncoder whose weights import from its
checkpoints), concatenated ``[camera, lidar]`` on channels and gated by
``BEVFuseLayer``, feed the CenterPoint head. Either branch alone feeds the
head directly. Both BEVs sit on the head's grid/8 input by construction; the
JAX package's bilinear resize for other grids is not ported and shapes that
differ raise.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .. import resolve_device
from ..configs import Config
from ..ops import circle_nms, voxel_pooling, voxelize, warp
from .bn_fold import BatchNorm2d
from .centerpoint_head import BEVDepthHead, SeparateHead
from .depth_net import DeformConv2d
from .fusion import BEVFuseLayer
from .lidar_encoder import LidarBEVEncoder
from .lss_fpn import LSSFPN
from .sparse_encoder import ImportSparseEncoder

LIDAR_VARIANTS = ('dense', 'sparse_import')

__all__ = ['BEVDepthLiDAR', 'check_card_limits', 'init_weights']


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


def check_card_limits(cfg: Config, device) -> None:
    """Raise ValueError, naming the knob, when ``cfg`` asks a kernel for more
    than it takes on ``device``: the decode's circle NMS (kernel K3) takes at
    most ``ops/circle_nms.py::MAX_SLOTS`` candidates a row on the card, the
    raw-rig splat (kernels K8, K8') camera features a multiple of 8 up
    to ``ops/voxel_pooling.py::RAW_MAX_C`` channels, and the sparse-import
    encoder's voxelization (kernel K1's sparse mode) at most
    ``ops/voxelize.py::MAX_FEATURES`` features and a point cap of at least 1
    and below 2^31, while the CPU path, like the JAX package, takes any
    number. Refused where the model is built, so a model that builds
    serves."""
    if torch.device(device).type != 'cuda':
        return
    max_num = cfg.get_head_conf().bbox_coder.max_num
    if max_num > circle_nms.MAX_SLOTS:
        raise ValueError(f'BBoxCoderConf.max_num = {max_num}: the card\'s circle NMS (kernel '
                         f'K3) takes at most {circle_nms.MAX_SLOTS} candidates a row; lower '
                         'it or build the model on the CPU')
    bb = cfg.get_backbone_conf()
    c, top = bb.output_channels, voxel_pooling.RAW_MAX_C
    if cfg.use_cam and not bb.factorized_splat and (c % 8 or not 8 <= c <= top):
        raise ValueError(f'BackboneConf.output_channels = {c}: the card\'s raw-rig splat '
                         f'(factorized_splat=False, kernels K8 and K8\') takes a multiple of 8 '
                         f'up to {top}; change it or build the model on the CPU')
    lconf = cfg.get_lidar_conf()
    if cfg.use_lidar and lconf.variant == 'sparse_import':
        vconf = lconf.voxelization
        if vconf.num_features > voxelize.MAX_FEATURES:
            raise ValueError(f'VoxelizationConf.num_features = {vconf.num_features}: the card\'s '
                             f'sparse-import voxelization (kernel K1) averages at most '
                             f'{voxelize.MAX_FEATURES}; lower it or build the model on the CPU')
        if not 1 <= vconf.max_num_points < 2 ** 31:
            raise ValueError(f'VoxelizationConf.max_num_points = {vconf.max_num_points}: the '
                             'card\'s sparse-import voxelization (kernel K1) caps a pillar at '
                             'between 1 and 2^31 - 1 points; change it or build the model on '
                             'the CPU')


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
        dev = resolve_device(device)
        super().__init__()
        if not (cfg.use_cam or cfg.use_lidar):
            raise ValueError('the model needs use_cam or use_lidar')
        check_card_limits(cfg, dev)
        lconf = cfg.get_lidar_conf()
        if cfg.use_lidar and lconf.variant not in LIDAR_VARIANTS:
            raise ValueError(f'LidarEncoderConf.variant = {lconf.variant!r}: one of '
                             f'{LIDAR_VARIANTS}')
        self.cfg = cfg
        with torch.device('meta'):   # no init work, no global RNG draws
            if cfg.use_cam:
                self.backbone = LSSFPN(cfg.get_backbone_conf())
            if cfg.use_lidar:
                enc_cls = (ImportSparseEncoder if lconf.variant == 'sparse_import'
                           else LidarBEVEncoder)
                self.lidar_encoder = enc_cls(
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
                raise ValueError(f'camera BEV {tuple(bevs[0].shape[2:])} and lidar BEV '
                                 f'{tuple(bevs[1].shape[2:])} differ: the bilinear resize '
                                 'between them is not ported')
            fused = self.bev_fuse(torch.cat(bevs, dim=1))
        else:
            fused = bevs[0]
        if fused.dtype != dtype:
            raise TypeError(f'the fused BEV is {fused.dtype}, not the compute dtype {dtype}')
        preds = self.head(fused)
        return (preds, depth) if return_depth else preds
