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
    with ``conv``/``bn`` children;
  * the image backbone's space-to-depth stem kernel [4, 4, 4*cin, cout]
    becomes the reference's 7x7 ``conv1`` (:func:`stem_7x7_from_s2d`; the
    taps the JAX stem masks out never enter its map and are dropped);
  * the DepthNet's DCN kernel [9, g, cg, og] becomes mmcv's
    [g*og, cg, 3, 3] and its ``conv_offset`` carries over. The DCN bias is
    kept as ``depth_conv.4.bias``, the one name beyond the reference's set:
    mmcv's DCN has none, and the JAX export folds it into ``depth_conv.5``'s
    bias, which is exact in eval but changes what training would update.
    The reference's ``reduce_conv.0`` bias is zeros; its dead
    ``context_se`` module has no counterpart in the port.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..configs import Config, HeadConf, LidarEncoderConf
from .resnet import DEPTH_CFG, Bottleneck

__all__ = ['state_dict_from_flax', 'resnet_state_dict', 'second_fpn_state_dict',
           'bev_head_state_dict', 'lidar_encoder_state_dict', 'depth_net_state_dict',
           'aspp_state_dict', 'deform_conv_state_dict', 'fuse_layer_state_dict',
           'stem_7x7_from_s2d']

StateDict = Dict[str, torch.Tensor]


def _stem_tap_map():
    """The space-to-depth stem's taps (``mm_training_tpu/models/resnet.py::
    _stem_tap_map``): the 7x7/2 conv is a 4x4/1 conv on the 2x2-blocked
    image whose tap (m, d) per axis reads 7x7 tap k = 2(m - 2) + d + 3.
    Returns (my, mx, block, ky, kx): blocked tap [my, mx], channel group
    ``block`` (dy * 2 + dx) <-> 7x7 tap [ky, kx]."""
    taps = []
    for my in range(4):
        for dy in range(2):
            ky = 2 * (my - 2) + dy + 3
            if not 0 <= ky < 7:
                continue
            for mx in range(4):
                for dx in range(2):
                    kx = 2 * (mx - 2) + dx + 3
                    if 0 <= kx < 7:
                        taps.append((my, mx, dy * 2 + dx, ky, kx))
    return taps


def stem_7x7_from_s2d(w4: np.ndarray) -> np.ndarray:
    """HWIO [4, 4, 4*cin, cout] space-to-depth stem kernel -> the HWIO
    [7, 7, cin, cout] kernel of the same map. Taps without a 7x7
    counterpart are masked out of the JAX stem's conv and are dropped."""
    w4 = np.asarray(w4)
    _, _, cin4, cout = w4.shape
    cin = cin4 // 4
    w7 = np.zeros((7, 7, cin, cout), w4.dtype)
    for my, mx, blk, ky, kx in _stem_tap_map():
        w7[ky, kx] = w4[my, mx, blk * cin:(blk + 1) * cin]
    return w7


def _t(x) -> torch.Tensor:
    # a copy: a reversed view with size-1 dims passes for contiguous but
    # keeps its negative strides
    return torch.from_numpy(np.array(x, order='C', copy=True))


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
                      prefix: str = '', depth: int = 18,
                      stem_s2d: bool = False) -> StateDict:
    """flax ``ResNet(depth)`` -> mmdet ResNet names; ``stem_s2d``: the flax
    stem is the space-to-depth form, carried over as the 7x7 ``conv1``."""
    out: StateDict = {}
    stem = params['stem']
    if stem_s2d:
        stem = {'Conv_0': {'kernel': stem_7x7_from_s2d(stem['Conv_0']['kernel'])},
                'BatchNorm_0': stem['BatchNorm_0']}
    _convbn(out, f'{prefix}conv1', f'{prefix}bn1', stem, stats['stem'])
    block, stage_blocks = DEPTH_CFG[depth]
    n_convs = 3 if block is Bottleneck else 2
    for i, blocks in enumerate(stage_blocks[:num_stages], start=1):
        for j in range(blocks):
            _res_block(out, f'{prefix}layer{i}.{j}', params[f'layer{i}_{j}'],
                       stats[f'layer{i}_{j}'], n_convs)
    return out


def _res_block(out: StateDict, prefix: str, p: Mapping, s: Mapping, n_convs: int) -> None:
    """A BasicBlock (2 ConvBNs) or Bottleneck (3), and the downsample
    ConvBN after them when the block has one."""
    for c in range(n_convs):
        _convbn(out, f'{prefix}.conv{c + 1}', f'{prefix}.bn{c + 1}',
                p[f'ConvBN_{c}'], s[f'ConvBN_{c}'])
    if f'ConvBN_{n_convs}' in p:
        _convbn(out, f'{prefix}.downsample.0', f'{prefix}.downsample.1',
                p[f'ConvBN_{n_convs}'], s[f'ConvBN_{n_convs}'])


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


_ASPP_NAMES = (('aspp1.atrous_conv', 'aspp1.bn'), ('aspp2.atrous_conv', 'aspp2.bn'),
               ('aspp3.atrous_conv', 'aspp3.bn'), ('aspp4.atrous_conv', 'aspp4.bn'),
               ('global_avg_pool.1', 'global_avg_pool.2'), ('conv1', 'bn1'))


def aspp_state_dict(params: Mapping, stats: Mapping, prefix: str = '') -> StateDict:
    """flax ``ASPP`` -> ``aspp{1..4}.atrous_conv``/``.bn``,
    ``global_avg_pool.1``/``.2``, ``conv1``/``bn1``."""
    out: StateDict = {}
    for k, (conv_name, bn_name) in enumerate(_ASPP_NAMES):
        _convbn(out, f'{prefix}{conv_name}', f'{prefix}{bn_name}',
                params[f'ConvBN_{k}'], stats[f'ConvBN_{k}'])
    return out


def fuse_layer_state_dict(params: Mapping, prefix: str = '') -> StateDict:
    """flax ``BEVFuseLayer`` -> ``conv_3``, ``conv_1`` (weights and biases)."""
    out: StateDict = {}
    for name in ('conv_3', 'conv_1'):
        _conv(out, f'{prefix}{name}', params[name]['kernel'])
        out[f'{prefix}{name}.bias'] = _t(params[name]['bias'])
    return out


def depth_net_state_dict(params: Mapping, stats: Mapping, prefix: str = '') -> StateDict:
    """flax ``DepthNet`` -> the reference's ``reduce_conv``, ``context_conv``
    and ``depth_conv.{0..5}`` names (BasicBlocks, ASPP, DCN, depth 1x1)."""
    out: StateDict = {}
    _convbn(out, f'{prefix}reduce_conv.0', f'{prefix}reduce_conv.1',
            params['reduce_conv'], stats['reduce_conv'], conv_bias=True)
    for name, flax_name in (('context_conv', 'context_conv'),
                            ('depth_conv.5', 'depth_pred')):
        _conv(out, f'{prefix}{name}', params[flax_name]['kernel'])
        out[f'{prefix}{name}.bias'] = _t(params[flax_name]['bias'])
    blocks = sorted(k for k in params if k.startswith('depth_block'))
    for i, k in enumerate(blocks):
        _res_block(out, f'{prefix}depth_conv.{i}', params[k], stats[k], 2)
    n = len(blocks)
    out.update(aspp_state_dict(params['aspp'], stats['aspp'], f'{prefix}depth_conv.{n}.'))
    if 'dcn' in params:
        out.update(deform_conv_state_dict(params['dcn'], f'{prefix}depth_conv.{n + 1}.'))
    return out


def deform_conv_state_dict(params: Mapping, prefix: str = '') -> StateDict:
    """flax ``DeformConv2d`` -> mmcv's ``weight`` [g*og, cg, 3, 3], the JAX
    module's ``bias`` and ``conv_offset``."""
    out: StateDict = {}
    k = np.asarray(params['kernel'])                      # [9, g, cg, og]
    _, g, cg, og = k.shape
    w = np.transpose(k.reshape(3, 3, g, cg, og), (2, 4, 3, 0, 1))
    out[f'{prefix}weight'] = _t(w.reshape(g * og, cg, 3, 3))
    out[f'{prefix}bias'] = _t(params['bias'])
    _conv(out, f'{prefix}conv_offset', params['conv_offset']['kernel'])
    out[f'{prefix}conv_offset.bias'] = _t(params['conv_offset']['bias'])
    return out


def state_dict_from_flax(params: Mapping, batch_stats: Mapping,
                         cfg: Config) -> StateDict:
    """Full flax ``BEVDepthLiDAR`` trees -> the state dict of
    :class:`mm_training_tpu_torch.models.BEVDepthLiDAR`: the camera branch
    (``backbone.img_backbone``, ``backbone.img_neck``, ``backbone.depth_net``),
    the fuse layer, the lidar encoder and the head, as the config has them."""
    out: StateDict = {}
    if cfg.use_cam:
        bb = cfg.get_backbone_conf()
        p, s = params['backbone'], batch_stats['backbone']
        out.update(resnet_state_dict(p['img_backbone'], s['img_backbone'], 4,
                                     prefix='backbone.img_backbone.',
                                     depth=bb.img_backbone_conf.depth,
                                     stem_s2d=bb.img_backbone_conf.stem_s2d))
        out.update(second_fpn_state_dict(p['img_neck'], s['img_neck'],
                                         bb.img_neck_conf.upsample_strides,
                                         prefix='backbone.img_neck.'))
        out.update(depth_net_state_dict(p['depth_net'], s['depth_net'],
                                        prefix='backbone.depth_net.'))
    if 'bev_fuse' in params:
        out.update(fuse_layer_state_dict(params['bev_fuse'], prefix='bev_fuse.'))
    if cfg.use_lidar:
        out.update(lidar_encoder_state_dict(params['lidar_encoder'],
                                            batch_stats['lidar_encoder'],
                                            cfg.get_lidar_conf(), prefix='lidar_encoder.'))
    out.update(bev_head_state_dict(params['head'], batch_stats['head'],
                                   cfg.get_head_conf(), prefix='head.'))
    return out
