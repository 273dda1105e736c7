"""Import the reference's torch checkpoints and torchvision backbones into
the port.

The port of ``mm_training_tpu/models/torch_import.py``. The port's modules
carry the reference's mmdet/mmdet3d names (``backbone.img_backbone.*``,
``backbone.img_neck.*``, ``backbone.depth_net.*``, ``head.*``,
``bev_fuse.*``, ``lidar_encoder.pts_middle_encoder.*``), so a reference
state dict loads almost as it is; what is left to convert:

  * the spconv SparseEncoder's 3D kernels ``[kd, kh, kw, I, O]`` become the
    sparse-import encoder's z-slice 2-D kernels (OIHW) at the tap the single
    occupied z-plane reads (:func:`convert_sparse_encoder`);
  * a torch conv bias that feeds a BN through a port conv without a bias is
    folded into the BN's running mean (``mean' = mean - bias``; exact in
    eval, and train-mode batch statistics cancel a constant shift), as the
    JAX ``_fold_bias_into_bn`` does;
  * the port's own ``backbone.depth_net.depth_conv.4.bias`` (mmcv's DCN has
    none) and ``head.shared_conv.conv.bias`` (when the checkpoint's shared
    conv has none) start at zero;
  * the reference's dead ``context_se`` module (instantiated, never called)
    is counted and dropped; with the dense LiDAR encoder the SparseEncoder
    keys are counted and skipped (that encoder has no reference
    counterpart).

:func:`convert_torchvision_resnet` maps a torchvision ResNet (the
``ImageBackboneConf.pretrained`` file) onto the image backbone, whose names
are torchvision's; its classifier ``fc`` is dropped.
"""
from __future__ import annotations

import pickle
import warnings
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from .bn_fold import conv_bn_pairs
from .weights import sparse_encoder_names

__all__ = ['SPARSE_PREFIX', 'convert_reference_checkpoint', 'convert_sparse_encoder',
           'convert_torchvision_resnet', 'load_reference_state_dict', 'merge_state_dict',
           'sparse_taps']

StateDict = Dict[str, torch.Tensor]

# the reference's SparseEncoder inside its BEVDepth model
SPARSE_PREFIX = 'lidar_encoder.pts_middle_encoder.'
# the reference's top-level modules (JAX import_checkpoint's known prefixes)
_MODULES = ('backbone', 'head', 'bev_fuse', 'lidar_encoder')
# port tensors the reference's checkpoints lack: zero at import
_PORT_ONLY = ('backbone.depth_net.depth_conv.4.bias', 'head.shared_conv.conv.bias')


def load_reference_state_dict(path: str) -> StateDict:
    """A .pth/.pt/.ckpt file -> {name: tensor}: a raw state dict or
    ``{'state_dict': ...}`` (Lightning). Wrapper prefixes (``module.``,
    ``model.``, ``backbone.``) are stripped only when EVERY key has them:
    ``backbone.`` is a real scope inside full reference checkpoints (JAX
    :49-67).

    The file is read with ``weights_only=True`` first. A Lightning
    checkpoint whose extra entries (hyperparameters, callbacks) are objects
    that refuses is said so in a warning and read as the JAX package reads
    it, ``weights_only=False``: unpickling runs the file's code, so only
    load files you trust."""
    try:
        obj = torch.load(path, map_location='cpu', weights_only=True)
    except pickle.UnpicklingError as e:
        warnings.warn(f'{path}: torch.load(weights_only=True) refused objects besides the '
                      f'tensors ({str(e).splitlines()[0]}); reading it with '
                      'weights_only=False, as the JAX package does', stacklevel=2)
        obj = torch.load(path, map_location='cpu', weights_only=False)
    sd = obj.get('state_dict', obj) if isinstance(obj, dict) else obj
    keys = list(sd.keys())
    for prefix in ('module.', 'model.', 'backbone.'):
        while keys and all(k.startswith(prefix) for k in keys):
            keys = [k[len(prefix):] for k in keys]
    return {k: v.detach().cpu() for k, v in zip(keys, sd.values())
            if isinstance(v, torch.Tensor)}


def sparse_taps(encoder_channels) -> Dict[str, int]:
    """{port name below ``pts_middle_encoder`` of each conv: the z-tap of its
    spconv kernel the single occupied plane reads}: kd = 1 for the
    submanifold convs and the z-padded strided convs of the stages before
    the last strided one; kd = 0 for the last strided conv (the reference's
    encoder_paddings z-pad 0) and for ``conv_out`` (kernel (3, 1, 1),
    padding 0) (JAX :317-368)."""
    names = sparse_encoder_names(encoder_channels)
    n = len(encoder_channels)
    taps = {}
    for scope, name in names.items():
        if scope.startswith('stage') and '_block' in scope:
            taps[f'{name}.conv1'] = taps[f'{name}.conv2'] = 1
        elif scope.startswith('stage'):
            si = int(scope[len('stage'):scope.index('_')])
            taps[f'{name}.0'] = 0 if si == n - 2 else 1
        else:
            taps[f'{name}.0'] = 0 if scope == 'conv_out' else 1
    return taps


def convert_sparse_encoder(state_dict: Mapping[str, torch.Tensor],
                           encoder_channels=((16, 16, 32), (32, 32, 64), (64, 64, 128),
                                             (128, 128)),
                           prefix: str = '') -> StateDict:
    """mmdet3d SparseEncoder keys (below ``prefix``) -> the port's
    ``SparseEncoder`` state dict (names without ``prefix``): each spconv
    kernel ``[kd, kh, kw, I, O]`` sliced at its tap (:func:`sparse_taps`)
    and laid out OIHW, every BN entry as it is. Raises naming a missing key
    or a kernel that is not 5-D."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    out: StateDict = {}
    taps = sparse_taps(encoder_channels)
    for conv, tap in taps.items():
        w = sd[f'{conv}.weight']
        if w.dim() != 5:
            raise ValueError(f'{prefix}{conv}.weight: expected a sparse [kd, kh, kw, I, O] '
                             f'kernel, got {tuple(w.shape)}')
        out[f'{conv}.weight'] = w[min(tap, w.shape[0] - 1)].permute(3, 2, 0, 1).contiguous()
    bns = [f'{c[:-len(".0")]}.1' if c.endswith('.0') else c.replace('.conv', '.bn')
           for c in taps]
    for bn in bns:
        for entry in ('weight', 'bias', 'running_mean', 'running_var', 'num_batches_tracked'):
            if f'{bn}.{entry}' in sd:
                out[f'{bn}.{entry}'] = sd[f'{bn}.{entry}']
            elif entry != 'num_batches_tracked':
                raise KeyError(f'{prefix}{bn}.{entry}')
    return out


def convert_torchvision_resnet(state_dict: Mapping[str, torch.Tensor],
                               prefix: str = '') -> StateDict:
    """A torchvision ResNet state dict -> the port's ResNet names under
    ``prefix`` (the same names: ``conv1``, ``bn1``, ``layer{i}.{j}.conv{c}``,
    ``downsample.{0,1}``); the classifier ``fc`` is dropped (JAX :125-131;
    the port's stem is the 7x7 conv itself)."""
    return {f'{prefix}{k}': v for k, v in state_dict.items() if not k.startswith('fc.')}


def merge_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor],
                     strict_prefix: Optional[str] = None) -> None:
    """Copy ``state`` into ``model``'s parameters and buffers (a shape that
    differs raises, as ``load_state_dict`` does); an entry the model lacks
    raises KeyError, and with ``strict_prefix`` so does an entry of the
    model under it that ``state`` does not give."""
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if strict_prefix is not None and k.startswith(strict_prefix)]
    if unexpected or missing:
        raise KeyError(f'not entries of the model: {unexpected[:8]}; missing under '
                       f'{strict_prefix!r}: {missing[:8]}')


def convert_reference_checkpoint(state_dict: Mapping[str, torch.Tensor], model: nn.Module
                                 ) -> Tuple[StateDict, dict]:
    """A full reference state dict (prefixes stripped, as
    :func:`load_reference_state_dict` returns it) -> (entries of ``model``'s
    state dict, a coverage report).

    Every module ``model`` has (camera branch, head, fuse layer; the LiDAR
    encoder with ``variant='sparse_import'``) must be covered: a key the
    model's module lacks, a shape that differs, or an entry of the module
    the checkpoint does not give (but the port-only biases, zero) raises.
    Keys of branches the model does not have (a camera branch for a LiDAR
    model: the reference's Lightning checkpoints carry every branch) are
    counted and skipped, as are the dead ``context_se`` keys and, with the
    dense LiDAR encoder, the SparseEncoder's. The report: ``source_keys``,
    ``converted_leaves`` (port tensors written), ``lidar_encoder``,
    ``skipped_lidar_encoder_keys``, ``skipped_dead_context_se_keys``,
    ``skipped_other_branch_keys``, ``folded_conv_biases``,
    ``unrecognized_keys`` (outside the reference's four modules)."""
    cfg = model.cfg
    own = model.state_dict()
    have = {name for name, _ in model.named_children()}
    sparse = cfg.use_lidar and cfg.get_lidar_conf().variant == 'sparse_import'
    partner = {conv: bn for conv, bn, _, _ in conv_bn_pairs(model)}
    out: StateDict = {}
    report = {'source_keys': len(state_dict), 'skipped_lidar_encoder_keys': 0,
              'skipped_dead_context_se_keys': 0, 'skipped_other_branch_keys': 0,
              'folded_conv_biases': 0, 'unrecognized_keys': []}
    biases = {}
    unmatched = []
    for k, v in state_dict.items():
        top = k.split('.', 1)[0]
        if top not in _MODULES:
            report['unrecognized_keys'].append(k)
        elif '.context_se.' in k:
            report['skipped_dead_context_se_keys'] += 1
        elif top not in have:
            report['skipped_other_branch_keys'] += 1
        elif top == 'lidar_encoder':
            if not sparse:
                report['skipped_lidar_encoder_keys'] += 1
            elif not k.startswith(SPARSE_PREFIX):
                unmatched.append(k)
        elif k in own:
            out[k] = v
        elif k.endswith('.bias') and k[:-len('.bias')] in partner:
            biases[k[:-len('.bias')]] = v
        else:
            unmatched.append(k)
    if unmatched:
        raise ValueError(f'{len(unmatched)} checkpoint keys match no entry of the port\'s '
                         f'modules: {unmatched[:8]}{" ..." if len(unmatched) > 8 else ""}')
    if sparse:
        out.update({SPARSE_PREFIX + k: v for k, v in convert_sparse_encoder(
            state_dict, cfg.get_lidar_conf().encoder_channels, SPARSE_PREFIX).items()})
    for conv, b in biases.items():
        mean = f'{partner[conv]}.running_mean'
        out[mean] = out[mean] - b.to(out[mean].dtype)
        report['folded_conv_biases'] += 1
    for k in _PORT_ONLY:
        if k in own and k not in out:
            out[k] = torch.zeros_like(own[k], device='cpu')
    for k, v in out.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f'{k}: {tuple(v.shape)} for the port\'s {tuple(own[k].shape)}')
        out[k] = v.to(own[k].dtype)
    needed = [k for k in own if k.split('.', 1)[0] in have and k not in out
              and not (k.startswith('lidar_encoder.') and not sparse)]
    if needed:
        raise KeyError(f'the checkpoint lacks {len(needed)} entries of the model: '
                       f'{needed[:8]}{" ..." if len(needed) > 8 else ""}')
    report['converted_leaves'] = len(out)
    report['lidar_encoder'] = ('converted (sparse_import)' if sparse
                               else 'skipped (dense encoder)' if cfg.use_lidar else 'none')
    report['unrecognized_keys'] = sorted(report['unrecognized_keys'])
    return out, report
