"""Predict step of the serving slice.

The port of ``mm_training_tpu/training/train_step.py::make_predict_step``
(:369-398) and ``cast_floating`` (:148-154): forward + decode, with the
weights cast to bf16 when ``cfg.precision == 'bf16'`` (BN statistics too)
and the pred maps cast back to float32 before decode. The train and eval
steps arrive with the training slice.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from ..configs import Config
from ..models import BEVDepthLiDAR, decode_boxes

__all__ = ['cast_floating', 'make_predict_step']


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast the floating tensors of a nested dict/list/tuple to ``dtype``;
    a module comes back as a cast copy (parameters and buffers)."""
    if isinstance(tree, nn.Module):
        return copy.deepcopy(tree).to(dtype)
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree


def make_predict_step(cfg: Config, model: BEVDepthLiDAR
                      ) -> Callable[[Dict[str, Any]], Tuple[torch.Tensor, ...]]:
    """Forward + decode only (predict_step, mm_training_aim.py:344-369).

    The returned ``predict_step(batch)`` takes a request batch (numpy arrays
    or tensors: ``points`` [B, P, F], ``point_mask`` [B, P]) and returns
    (boxes [B, T*83, 9], scores, labels, valid) on the model's device."""
    head_conf = cfg.get_head_conf()
    net = cast_floating(model, torch.bfloat16) if cfg.precision == 'bf16' else model
    net.eval()
    device = next(net.parameters()).device

    @torch.inference_mode()
    def predict_step(batch: Dict[str, Any]) -> Tuple[torch.Tensor, ...]:
        points = torch.as_tensor(batch['points'], dtype=torch.float32, device=device)
        mask = torch.as_tensor(batch['point_mask'], dtype=torch.bool, device=device)
        preds = net(points, mask)
        return decode_boxes(head_conf, cast_floating(preds, torch.float32))

    return predict_step
