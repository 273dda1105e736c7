"""Train, eval and predict steps of the LiDAR / LiDAR+radar model.

The port of ``mm_training_tpu/training/train_step.py`` without the camera:
``TrainState`` and ``create_train_state``, ``make_train_step`` (JAX
:183-257), ``make_eval_step`` (:311-367), ``make_predict_step`` (:369-398)
and ``cast_floating`` (:148-154).

Mixed precision is the JAX step's cast, not autocast: with
``cfg.precision == 'bf16'`` the float32 master parameters are cast to bf16
inside the differentiated function (``torch.func.functional_call`` on the
cast copies), so every layer computes in bf16 and the gradients reach the
float32 masters; the pred maps go back to float32 before the loss. Train-mode
BatchNorm updates the float32 master statistics in place (rounding the old
ones to bf16 first, as the JAX step's cast of ``batch_stats`` does). Eval
and predict cast the statistics too.

EMA weights (``use_ema``) and ``make_train_step_multi`` (K steps a dispatch)
arrive with the runtime slice, the camera inputs (``use_cam``) with the
camera slice; both are refused until then.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..configs import Config
from ..models import BEVDepthLiDAR, decode_boxes
from ..models.centerpoint_head import detection_loss, get_targets
from .optim import AdamW, make_optimizer

__all__ = ['TrainState', 'cast_floating', 'create_train_state', 'loss_and_grads',
           'make_eval_step', 'make_predict_step', 'make_train_step']


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


@dataclass
class TrainState:
    """What a train step advances: the step count, the model (float32
    master parameters and BatchNorm statistics) and its optimizer."""
    step: int
    model: BEVDepthLiDAR
    optimizer: AdamW


def create_train_state(cfg: Config, model: BEVDepthLiDAR, steps_per_epoch: int = 1000,
                       global_batch_scale: int = 1) -> TrainState:
    """Step 0 with :func:`~mm_training_tpu_torch.training.optim.make_optimizer`
    over the model's parameters (in ``named_parameters`` order)."""
    if cfg.use_ema:
        raise NotImplementedError('EMA weights (use_ema) arrive with the runtime '
                                  'slice (slice 4) of the port')
    opt = make_optimizer(cfg, model.parameters(), steps_per_epoch, global_batch_scale)
    return TrainState(step=0, model=model, optimizer=opt)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _as(batch: Dict[str, Any], key: str, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(batch[key], device=device).to(dtype)


def _compute_weights(cfg: Config, model: nn.Module, buffers: bool) -> Dict[str, torch.Tensor]:
    """The tensors a step runs the model with: bf16 casts of the float32
    masters under ``precision == 'bf16'`` (differentiable casts), else the
    masters; the floating buffers too when ``buffers``."""
    named = dict(model.named_parameters())
    if buffers:
        named.update((n, b) for n, b in model.named_buffers() if b.is_floating_point())
    if cfg.precision != 'bf16':
        return named
    return {n: t.to(torch.bfloat16) for n, t in named.items()}


def _targets(cfg: Config, batch: Dict[str, Any], device):
    return get_targets(cfg.get_head_conf(), _as(batch, 'gt_boxes', torch.float32, device),
                       _as(batch, 'gt_labels', torch.int64, device),
                       _as(batch, 'gt_mask', torch.bool, device))


def loss_and_grads(cfg: Config, state: TrainState, batch: Dict[str, Any]):
    """One forward and backward in train mode: (detection loss, gradients
    in ``named_parameters`` order, float32). Updates the BatchNorm running
    statistics in place."""
    model = state.model
    device = _device(model)
    targets = _targets(cfg, batch, device)
    points = _as(batch, 'points', torch.float32, device)
    mask = _as(batch, 'point_mask', torch.bool, device)
    model.train()
    params = list(model.parameters())
    preds = torch.func.functional_call(model, _compute_weights(cfg, model, False),
                                       (points, mask))
    det = detection_loss(cfg.get_head_conf(), targets, cast_floating(preds, torch.float32))
    grads = torch.autograd.grad(det, params)
    return det.detach(), grads


def make_train_step(cfg: Config) -> Callable[[TrainState, Dict[str, Any]],
                                             Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``train_step(state, batch) -> (state, metrics)``.

    ``batch``: numpy arrays or tensors with ``points`` [B, P, F],
    ``point_mask`` [B, P], ``gt_boxes`` [B, K, 9], ``gt_labels`` [B, K],
    ``gt_mask`` [B, K]. Targets (kernel K2), the forward in train mode,
    the detection loss, its gradients, then the clipped AdamW update of the
    float32 masters. The state is updated in place (the JAX step donates
    its input) and returned with ``step + 1``; ``metrics`` holds
    ``train_loss``, ``train_detection_loss``, ``train_depth_loss`` (0 without
    the camera) and ``grad_norm`` (before clipping) as 0-dim tensors on the
    device, read without a host wait."""
    if cfg.use_cam:
        raise NotImplementedError('the camera inputs of the train step arrive with '
                                  'slice 3 of the port')
    if cfg.use_ema:
        raise NotImplementedError('EMA weights (use_ema) arrive with the runtime '
                                  'slice (slice 4) of the port')

    def train_step(state: TrainState, batch: Dict[str, Any]):
        det, grads = loss_and_grads(cfg, state, batch)
        grad_norm = state.optimizer.step(grads)
        state.step += 1
        metrics = {'train_loss': det, 'train_detection_loss': det,
                   'train_depth_loss': torch.zeros((), device=det.device),
                   'grad_norm': grad_norm}
        return state, metrics

    return train_step


def make_eval_step(cfg: Config) -> Callable:
    """``eval_step(state, batch) -> (metrics, (boxes, scores, labels, valid),
    viz)``: forward in eval mode (bf16 casts of the parameters and
    statistics under ``precision == 'bf16'``), the detection loss with the
    batch's optional ``sample_valid`` [B] mask, decode with circle NMS.
    ``metrics``: ``detection_loss``, ``depth_loss`` (0), ``loss``; ``viz``:
    ``heatmaps`` [T, H, W], each task's max-class heatmap of the first
    sample in sigmoid space."""
    if cfg.use_cam:
        raise NotImplementedError('the camera inputs of the eval step arrive with '
                                  'slice 3 of the port')
    head_conf = cfg.get_head_conf()

    @torch.no_grad()     # not inference_mode: BatchNorm's s, t cache reads versions
    def eval_step(state: TrainState, batch: Dict[str, Any]):
        model = state.model
        device = _device(model)
        model.eval()
        points = _as(batch, 'points', torch.float32, device)
        mask = _as(batch, 'point_mask', torch.bool, device)
        preds = torch.func.functional_call(model, _compute_weights(cfg, model, True),
                                           (points, mask))
        preds = cast_floating(preds, torch.float32)
        sample_valid: Optional[torch.Tensor] = None
        if 'sample_valid' in batch:
            sample_valid = _as(batch, 'sample_valid', torch.bool, device)
        det = detection_loss(head_conf, _targets(cfg, batch, device), preds,
                             sample_mask=sample_valid)
        dep = torch.zeros((), device=device)
        viz = {'heatmaps': torch.stack([torch.sigmoid(p['heatmap'][0].amax(-1))
                                        for p in preds])}
        metrics = {'detection_loss': det, 'depth_loss': dep, 'loss': det + dep}
        return metrics, decode_boxes(head_conf, preds), viz

    return eval_step


def make_predict_step(cfg: Config, model: BEVDepthLiDAR
                      ) -> Callable[[Dict[str, Any]], Tuple[torch.Tensor, ...]]:
    """Forward + decode only (predict_step, mm_training_aim.py:344-369).

    The returned ``predict_step(batch)`` takes a request batch (numpy arrays
    or tensors: ``points`` [B, P, F], ``point_mask`` [B, P]) and returns
    (boxes [B, T*83, 9], scores, labels, valid) on the model's device."""
    head_conf = cfg.get_head_conf()
    net = cast_floating(model, torch.bfloat16) if cfg.precision == 'bf16' else model
    net.eval()
    device = _device(net)

    @torch.inference_mode()
    def predict_step(batch: Dict[str, Any]) -> Tuple[torch.Tensor, ...]:
        points = torch.as_tensor(batch['points'], dtype=torch.float32, device=device)
        mask = torch.as_tensor(batch['point_mask'], dtype=torch.bool, device=device)
        preds = net(points, mask)
        return decode_boxes(head_conf, cast_floating(preds, torch.float32))

    return predict_step
