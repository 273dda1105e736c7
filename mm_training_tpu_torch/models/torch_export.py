"""Export the port's weights as a reference-format checkpoint.

The port of ``mm_training_tpu/models/torch_export.py``, the inverse of
``models/torch_import.py``: a port state dict (the model's, or an EMA shadow
keyed like it) becomes the reference's ``{'state_dict': {'model.…'}}``
Lightning layout, which the reference's eval and inference scripts and the
released-checkpoint tooling load. The port already carries the reference's
names, so what is left:

  * the sparse-import encoder's z-slice kernels go back into the active tap
    of spconv's ``[kd, kh, kw, I, O]`` kernels, zeros at the other taps
    (exact for single-occupied-z-plane inputs, the reference geometry; JAX
    :209-250);
  * the port's DCN bias (mmcv's DCN has none) is folded into the 1x1 conv
    it feeds, ``depth_conv.5`` (no BN or activation between: W(d + b) + c =
    Wd + (c + Wb)), exact in eval and bit for bit when the bias is zero;
  * the reference's dead ``context_se`` module is written zero-initialized,
    so a strict load of the reference model succeeds;
  * the dense LiDAR encoder has no reference counterpart and is left out.

``torch_import.convert_reference_checkpoint`` of the export gives the state
back bit for bit (tested for both LiDAR variants).
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..configs import Config
from .torch_import import SPARSE_PREFIX, sparse_taps

__all__ = ['export_reference_checkpoint', 'export_sparse_encoder', 'save_torch_checkpoint']

StateDict = Dict[str, torch.Tensor]
_DCN = 'backbone.depth_net.depth_conv.4'
_DEPTH_PRED = 'backbone.depth_net.depth_conv.5'


def export_sparse_encoder(state: Mapping[str, torch.Tensor], encoder_channels,
                          prefix: str = '') -> StateDict:
    """The port's ``SparseEncoder`` entries (below ``prefix``) -> the
    reference's (the same names): each OIHW z-slice kernel placed at its
    tap of a zero [3, kh, kw, I, O] spconv kernel; every other entry as it
    is."""
    out: StateDict = {}
    taps = sparse_taps(encoder_channels)
    for k, v in state.items():
        if not k.startswith(prefix):
            continue
        name = k[len(prefix):]
        conv = name[:-len('.weight')]
        if conv in taps:
            k2 = v.permute(2, 3, 1, 0)                     # OIHW -> HWIO
            k3 = torch.zeros((3,) + tuple(k2.shape), dtype=v.dtype, device=v.device)
            k3[taps[conv]] = k2
            out[k] = k3
        else:
            out[k] = v
    return out


def export_reference_checkpoint(state: Mapping[str, torch.Tensor], cfg: Config,
                                lightning_prefix: bool = True) -> StateDict:
    """A port state dict -> the reference's state dict (``model.*`` keys
    with ``lightning_prefix``), every tensor on the CPU. Raises on a folded
    state (``models/bn_fold.py``): its BNs have no statistics to export."""
    if 'head.shared_conv.bn.running_mean' not in state:
        raise ValueError('export_reference_checkpoint: the state has no BN statistics (a '
                         'folded model?); export the unfolded weights')
    state = {k: v.detach().cpu() for k, v in state.items()}
    lconf = cfg.get_lidar_conf()
    out: StateDict = {}
    for k, v in state.items():
        if k.startswith('lidar_encoder.') or k == f'{_DCN}.bias':
            continue
        out[k] = v
    if cfg.use_cam:
        w = state[f'{_DEPTH_PRED}.weight']                 # [D, mid, 1, 1]
        bias = state.get(f'{_DCN}.bias')
        if bias is not None:
            out[f'{_DEPTH_PRED}.bias'] = (state[f'{_DEPTH_PRED}.bias']
                                          + w[:, :, 0, 0].to(bias.dtype) @ bias)
        mid = cfg.get_backbone_conf().depth_net_conf.mid_channels
        for nm in ('conv_reduce', 'conv_expand'):
            out[f'backbone.depth_net.context_se.{nm}.weight'] = torch.zeros(mid, mid, 1, 1)
            out[f'backbone.depth_net.context_se.{nm}.bias'] = torch.zeros(mid)
    if cfg.use_lidar and lconf.variant == 'sparse_import':
        out.update(export_sparse_encoder(state, lconf.encoder_channels, SPARSE_PREFIX))
    if lightning_prefix:
        out = {f'model.{k}': v for k, v in out.items()}
    return out


def save_torch_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write a reference-loadable checkpoint, ``{'state_dict': {...}}``."""
    torch.save({'state_dict': {k: v.contiguous() for k, v in state_dict.items()}}, path)
