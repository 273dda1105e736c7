"""Train, eval and predict steps.

The port of ``mm_training_tpu/training/train_step.py``: ``TrainState`` and
``create_train_state``, ``make_train_step`` (JAX :183-257),
``make_eval_step`` (:311-367), ``make_predict_step`` (:369-398),
``cast_floating`` (:148-154), ``normalize_images`` (:74-81) and the eval
half of ``_prepare_camera_inputs`` (:84-145: depth labels from a
precomputed ``depth_gt`` or from kernel K6 on the un-augmented points, no
flips, the key frame's labels as the depth oracle when ``use_depth_loss``).
The predict step serves every modality; the train and eval steps serve the
LiDAR / LiDAR+radar models.

Mixed precision is the JAX step's cast, not autocast: with
``cfg.precision == 'bf16'`` the float32 master parameters are cast to bf16
inside the differentiated function (``torch.func.functional_call`` on the
cast copies), so every layer computes in bf16 and the gradients reach the
float32 masters; the pred maps go back to float32 before the loss. Train-mode
BatchNorm updates the float32 master statistics in place (rounding the old
ones to bf16 first, as the JAX step's cast of ``batch_stats`` does). Eval
and predict cast the statistics too.

EMA weights (``use_ema``) and ``make_train_step_multi`` (K steps a dispatch)
arrive with the runtime slice, the camera's train and eval steps (the
random flip, the depth loss, the backward kernels) with the camera training
slice; both are refused until then.
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
from ..ops import depth_labels as depth_label_ops
from .optim import AdamW, make_optimizer

__all__ = ['IMAGENET_MEAN', 'IMAGENET_STD', 'TrainState', 'cast_floating',
           'camera_inputs', 'create_train_state', 'loss_and_grads', 'make_eval_step',
           'make_predict_step', 'make_train_step', 'normalize_images']

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


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
                                  'slice (slice 5) of the port')
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
        raise NotImplementedError('the camera train step arrives with the camera '
                                  'training slice (slice 4) of the port')
    if cfg.use_ema:
        raise NotImplementedError('EMA weights (use_ema) arrive with the runtime '
                                  'slice (slice 5) of the port')

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
        raise NotImplementedError('the camera eval step arrives with the camera '
                                  'training slice (slice 4) of the port')
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


def normalize_images(imgs: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalise uint8 (or float 0-255) images [..., 3+] ->
    float32 [..., 3]. The divisions are by tensors: PyTorch's CUDA path
    divides by a Python number through its reciprocal, which rounds
    differently from the JAX package's true division."""
    x = imgs[..., :3].float()
    scale, mean, std = (torch.tensor(v, dtype=torch.float32, device=x.device)
                        for v in (255.0, IMAGENET_MEAN, IMAGENET_STD))
    return (x / scale - mean) / std


def camera_inputs(cfg: Config, batch: Dict[str, Any], device,
                  points: Optional[torch.Tensor] = None,
                  point_mask: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The camera keyword arguments of :class:`BEVDepthLiDAR` for an eval or
    predict batch (no image flipped): the images copied as they come
    (uint8) and normalised on the device, the float32 matrices, and with
    ``use_depth_loss`` the key frame's one-hot depth labels as the oracle,
    from ``depth_gt`` [B, N, fH, fW] when the batch carries it, else from
    kernel K6 on the points (``points``/``point_mask`` when the caller has
    them on the device already) un-rotated by ``inv(bda_mat)``."""
    bb = cfg.get_backbone_conf()
    imgs = normalize_images(torch.as_tensor(batch['imgs'], device=device))
    mats = {k: _as(batch, k, torch.float32, device) for k in ('sensor2ego', 'intrin')}
    bda = _as(batch, 'bda_mat', torch.float32, device)
    oracle = None
    if cfg.use_depth_loss:
        b, _, n = imgs.shape[:3]
        if 'depth_gt' in batch:
            grid = _as(batch, 'depth_gt', torch.float32, device)
            oracle = depth_label_ops.depth_grid_to_onehot(grid, bb.d_bound, bb.depth_channels)
        else:
            # only the key frame's labels are read: project into sweep 0's
            # cameras (inv_ex: no host wait on the error flag)
            inv_bda = torch.linalg.inv_ex(bda)[0][:, :3, :3]
            if points is None:
                points = _as(batch, 'points', torch.float32, device)
                point_mask = _as(batch, 'point_mask', torch.bool, device)
            xyz = points[..., :3] @ inv_bda.transpose(1, 2)
            oracle = depth_label_ops.depth_labels(
                xyz, point_mask, _as(batch, 'extrinsics', torch.float32, device)[:, 0],
                mats['intrin'][:, 0], cfg.final_dim, bb.downsample_factor, bb.d_bound,
                bb.depth_channels)
        oracle = oracle.reshape(b * n, *oracle.shape[-3:])
    return dict(imgs=imgs, bda_mat=bda, depth_oracle=oracle, **mats)


def make_predict_step(cfg: Config, model: BEVDepthLiDAR
                      ) -> Callable[[Dict[str, Any]], Tuple[torch.Tensor, ...]]:
    """Forward + decode only (predict_step, mm_training_aim.py:344-369).

    The returned ``predict_step(batch)`` takes a request batch (numpy arrays
    or tensors: ``points`` [B, P, F] and ``point_mask`` [B, P] with the
    LiDAR; ``imgs`` uint8 [B, S, N, H, W, 3], ``sensor2ego``, ``intrin``,
    ``extrinsics`` [B, S, N, 4, 4] and ``bda_mat`` [B, 4, 4] with the
    camera) and returns (boxes [B, T*83, 9], scores, labels, valid) on the
    model's device."""
    head_conf = cfg.get_head_conf()
    net = cast_floating(model, torch.bfloat16) if cfg.precision == 'bf16' else model
    net.eval()
    device = _device(net)

    @torch.inference_mode()
    def predict_step(batch: Dict[str, Any]) -> Tuple[torch.Tensor, ...]:
        points = mask = None
        if cfg.use_lidar:
            points = _as(batch, 'points', torch.float32, device)
            mask = _as(batch, 'point_mask', torch.bool, device)
        cam = camera_inputs(cfg, batch, device, points, mask) if cfg.use_cam else {}
        preds = net(points, mask, **cam)
        return decode_boxes(head_conf, cast_floating(preds, torch.float32))

    return predict_step
