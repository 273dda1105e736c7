"""Weight carry: JAX/flax parameter trees -> the port's state dict.

The port's own copy of the rules in ``mm_training_tpu/models/torch_export.py``
(:48-116, :175-206). It takes the flax ``params`` and ``batch_stats`` trees
(the BN running means and variances) as numpy arrays and returns tensors
keyed by the port's module names; any tree shaped like ``params`` (an
optimizer moment, say) maps the same way:

  * trunk, neck and head use the reference's mmdet/mmdet3d names, so the
    same dict also loads into the reference head;
  * conv kernels go HWIO -> OIHW;
  * a ConvTranspose kernel [kH, kW, I, O] is un-flipped spatially
    (``k[::-1, ::-1]``, second_fpn.py:49) and goes to [I, O, kH, kW];
  * a SeparateHead branch conv's flax bias is folded into the following
    BN's running mean (mean' = mean - bias), because the reference's
    ConvModule has no conv bias under BN. Exact in eval; in train mode the
    batch statistics cancel the bias anyway, and the running mean a train
    step leaves carries over with the bias the step started from;
  * the reference's shared conv has a bias the flax ConvBN lacks: zeros;
  * the dense lidar encoder has no reference counterpart: its names mirror
    the flax scopes (``stage{si}_conv{ci}``, ``out_conv``), each a ConvBN
    with ``conv``/``bn`` children.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..configs import Config, HeadConf, LidarEncoderConf

__all__ = ['state_dict_from_flax', 'resnet_state_dict', 'second_fpn_state_dict',
           'bev_head_state_dict', 'lidar_encoder_state_dict']

StateDict = Dict[str, torch.Tensor]

_STAGE_BLOCKS_18 = (2, 2, 2, 2)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _conv(out: StateDict, name: str, kernel) -> None:
    out[f'{name}.weight'] = _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _bn(out: StateDict, name: str, p: Mapping, s: Mapping, bias_fold=None) -> None:
    out[f'{name}.weight'] = _t(p['scale'])
    out[f'{name}.bias'] = _t(p['bias'])
    mean = np.asarray(s['mean'])
    if bias_fold is not None:
        mean = mean - np.asarray(bias_fold)
    out[f'{name}.running_mean'] = _t(mean)
    out[f'{name}.running_var'] = _t(s['var'])
    out[f'{name}.num_batches_tracked'] = torch.tensor(0, dtype=torch.int64)


def _convbn(out: StateDict, conv_name: str, bn_name: str, p: Mapping, s: Mapping,
            conv_bias: bool = False) -> None:
    kernel = p['Conv_0']['kernel']
    _conv(out, conv_name, kernel)
    if conv_bias:
        out[f'{conv_name}.bias'] = torch.zeros(np.asarray(kernel).shape[-1])
    _bn(out, bn_name, p['BatchNorm_0'], s['BatchNorm_0'])


def resnet_state_dict(params: Mapping, stats: Mapping, num_stages: int,
                      prefix: str = '') -> StateDict:
    """flax ``ResNet(depth=18)`` (plain stem) -> mmdet ResNet names."""
    out: StateDict = {}
    _convbn(out, f'{prefix}conv1', f'{prefix}bn1', params['stem'], stats['stem'])
    for i, blocks in enumerate(_STAGE_BLOCKS_18[:num_stages], start=1):
        for j in range(blocks):
            p, s = params[f'layer{i}_{j}'], stats[f'layer{i}_{j}']
            blk = f'{prefix}layer{i}.{j}'
            for c in (0, 1):
                _convbn(out, f'{blk}.conv{c + 1}', f'{blk}.bn{c + 1}',
                        p[f'ConvBN_{c}'], s[f'ConvBN_{c}'])
            if 'ConvBN_2' in p:
                _convbn(out, f'{blk}.downsample.0', f'{blk}.downsample.1',
                        p['ConvBN_2'], s['ConvBN_2'])
    return out


def second_fpn_state_dict(params: Mapping, stats: Mapping, upsample_strides,
                          prefix: str = '') -> StateDict:
    """flax ``SECONDFPN`` -> mmdet3d ``deblocks.{i}.0`` / ``.1``."""
    out: StateDict = {}
    for i, us in enumerate(upsample_strides):
        k = np.asarray(params[f'deblock{i}_conv']['kernel'])
        if us >= 1:  # ConvTranspose [kH, kW, I, O] -> [I, O, kH, kW], un-flipped
            out[f'{prefix}deblocks.{i}.0.weight'] = _t(
                np.transpose(k[::-1, ::-1], (2, 3, 0, 1)))
        else:
            _conv(out, f'{prefix}deblocks.{i}.0', k)
        _bn(out, f'{prefix}deblocks.{i}.1', params[f'deblock{i}_bn'],
            stats[f'deblock{i}_bn'])
    return out


def bev_head_state_dict(params: Mapping, stats: Mapping, head_conf: HeadConf,
                        prefix: str = '') -> StateDict:
    """flax ``BEVDepthHead`` -> the reference head's names."""
    out = resnet_state_dict(params['trunk'], stats['trunk'],
                            head_conf.bev_backbone_conf.num_stages,
                            prefix=f'{prefix}trunk.')
    out.update(second_fpn_state_dict(params['neck'], stats['neck'],
                                     head_conf.bev_neck_conf.upsample_strides,
                                     prefix=f'{prefix}neck.'))
    _convbn(out, f'{prefix}shared_conv.conv', f'{prefix}shared_conv.bn',
            params['shared_conv'], stats['shared_conv'], conv_bias=True)
    for t, task in enumerate(head_conf.tasks):
        p, s = params[f'task{t}'], stats[f'task{t}']
        heads = tuple(head_conf.common_heads) + (('heatmap', (task.num_class, 2)),)
        for name, (_, num_conv) in heads:
            base = f'{prefix}task_heads.{t}.{name}'
            for i in range(num_conv - 1):
                _conv(out, f'{base}.{i}.conv', p[f'{name}_conv{i}']['kernel'])
                _bn(out, f'{base}.{i}.bn', p[f'{name}_bn{i}'], s[f'{name}_bn{i}'],
                    bias_fold=p[f'{name}_conv{i}']['bias'])
            f = num_conv - 1
            _conv(out, f'{base}.{f}', p[f'{name}_final']['kernel'])
            out[f'{base}.{f}.bias'] = _t(p[f'{name}_final']['bias'])
    return out


def lidar_encoder_state_dict(params: Mapping, stats: Mapping,
                             conf: LidarEncoderConf, prefix: str = '') -> StateDict:
    """flax dense ``LidarBEVEncoder`` -> ``stage{si}_conv{ci}.conv/.bn``,
    ``out_conv.conv/.bn``."""
    out: StateDict = {}
    names = [f'stage{si}_conv{ci}' for si, stage in enumerate(conf.encoder_channels)
             for ci in range(len(stage))] + ['out_conv']
    for n in names:
        _convbn(out, f'{prefix}{n}.conv', f'{prefix}{n}.bn', params[n], stats[n])
    return out


def state_dict_from_flax(params: Mapping, batch_stats: Mapping,
                         cfg: Config) -> StateDict:
    """Full flax ``BEVDepthLiDAR`` trees (lidar branch) -> the state dict of
    :class:`mm_training_tpu_torch.models.BEVDepthLiDAR`."""
    out = lidar_encoder_state_dict(params['lidar_encoder'],
                                   batch_stats['lidar_encoder'],
                                   cfg.get_lidar_conf(), prefix='lidar_encoder.')
    out.update(bev_head_state_dict(params['head'], batch_stats['head'],
                                   cfg.get_head_conf(), prefix='head.'))
    return out
