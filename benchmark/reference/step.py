"""The reference's steps: a frozen copy of the port's train and predict
steps (``training/train_step.py``) on their plain path, in one process.

``loss_and_grads`` is one train-mode forward and backward (targets, the
camera's labels and flips from the draws handed in, the detection loss plus
the depth loss); ``train_step`` adds the clipped AdamW update of
``training/optim.py``; ``predict`` is the eval-mode forward and the decode.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch
from torch import nn

from .configs import Config
from .models import decode_boxes
from .models.bn_fold import begin_step
from .models.centerpoint_head import detection_loss, get_targets
from .ops import depth_labels as depth_label_ops


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


def _points(cfg: Config, batch: Dict[str, Any], device):
    """(points, point_mask) on the device when the LiDAR branch or the depth
    labels (no ``depth_gt`` in the batch) read them, else (None, None)."""
    if cfg.use_lidar or (cfg.use_cam and 'depth_gt' not in batch):
        return (_as(batch, 'points', torch.float32, device),
                _as(batch, 'point_mask', torch.bool, device))
    return None, None


def _targets(cfg: Config, batch: Dict[str, Any], device):
    return get_targets(cfg.get_head_conf(), _as(batch, 'gt_boxes', torch.float32, device),
                       _as(batch, 'gt_labels', torch.int64, device),
                       _as(batch, 'gt_mask', torch.bool, device))


def depth_loss_fn(depth_labels: torch.Tensor, depth_preds: torch.Tensor,
                  sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3.0 x the foreground-masked binary cross-entropy of the depth bins
    (JAX ``depth_loss_fn``; the foreground mask ``max(labels) > 0`` is
    all-true for one-hot labels with bin 0, the reference's quirk kept).

    depth_labels [B*N, fH, fW, D] float32 (the JAX layout), depth_preds
    [B*N, D, fH, fW] (the port's: the model's key-frame depth), rounded to
    float32 first as the JAX step does (also under x64), clipped to [1e-7,
    1 - 1e-7]. ``sample_mask`` [B] drops a padded eval sample's pixels
    exactly. In a process group the foreground count is the group's, as
    :func:`~mm_training_tpu_torch.models.centerpoint_head.detection_loss`
    takes its normalizers (model peers hold the same rows: counted once).
    Plain torch: the JAX package leaves it to XLA."""
    d = depth_labels.shape[-1]
    t = depth_labels.reshape(-1, d)
    p = depth_preds.float().permute(0, 2, 3, 1).reshape(-1, d).clamp(1e-7, 1 - 1e-7)
    fg = (t.amax(1) > 0.0).to(p.dtype)
    if sample_mask is not None:
        fg = fg * sample_mask.to(p.dtype).repeat_interleave(fg.shape[0] // sample_mask.shape[0])
    bce = -(t * torch.log(p) + (1 - t) * torch.log(1 - p))
    per_px = bce.sum(-1) * fg
    return 3.0 * per_px.sum() / fg.sum().clamp_min(1.0)


def normalize_images(imgs: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalise uint8 (or float 0-255) images [..., 3+] ->
    float32 [..., 3]. The divisions are by tensors: PyTorch's CUDA path
    divides by a Python number through its reciprocal, which rounds
    differently from the JAX package's true division."""
    x = imgs[..., :3].float()
    scale, mean, std = (torch.tensor(v, dtype=torch.float32, device=x.device)
                        for v in (255.0, IMAGENET_MEAN, IMAGENET_STD))
    return (x / scale - mean) / std


def _key_labels(cfg: Config, batch: Dict[str, Any], device, bda: torch.Tensor,
                points: Optional[torch.Tensor], point_mask: Optional[torch.Tensor],
                intrin: torch.Tensor) -> torch.Tensor:
    """The key frame's one-hot depth labels [B*N, fH, fW, D] float32: from
    ``depth_gt`` [B, N, fH, fW] when the batch carries it (K6's binning),
    else kernel K6 on the points un-rotated by ``inv(bda)``, projected into
    sweep 0's cameras (only the key frame's labels are read)."""
    bb = cfg.get_backbone_conf()
    if 'depth_gt' in batch:
        grid = _as(batch, 'depth_gt', torch.float32, device)
        labels = depth_label_ops.depth_grid_to_onehot(grid, bb.d_bound, bb.depth_channels)
    else:
        # inv_ex: no host wait on the error flag
        inv_bda = torch.linalg.inv_ex(bda)[0][:, :3, :3]
        if points is None:
            points = _as(batch, 'points', torch.float32, device)
            point_mask = _as(batch, 'point_mask', torch.bool, device)
        xyz = points[..., :3] @ inv_bda.transpose(1, 2)
        labels = depth_label_ops.depth_labels(
            xyz, point_mask, _as(batch, 'extrinsics', torch.float32, device)[:, 0],
            intrin[:, 0], cfg.final_dim, bb.downsample_factor, bb.d_bound, bb.depth_channels)
    return labels.reshape(-1, *labels.shape[-3:])


def _camera_tensors(batch: Dict[str, Any], device, flipped: Optional[torch.Tensor]):
    """(images normalised on the device, flipped where ``flipped`` [B*S*N]
    says; the float32 matrices)."""
    imgs = torch.as_tensor(batch['imgs'], device=device)
    if flipped is not None:
        sel = flipped.reshape(*imgs.shape[:3], 1, 1, 1)
        imgs = torch.where(sel, imgs.flip(-2), imgs)     # elementwise: before normalising
    mats = {k: _as(batch, k, torch.float32, device) for k in ('sensor2ego', 'intrin', 'bda_mat')}
    return normalize_images(imgs), mats


def camera_inputs(cfg: Config, batch: Dict[str, Any], device,
                  points: Optional[torch.Tensor] = None,
                  point_mask: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The camera keyword arguments of :class:`BEVDepthLiDAR` for a predict
    batch (no image flipped): the images copied as they come (uint8) and
    normalised on the device, the float32 matrices, and with
    ``use_depth_loss`` the key frame's one-hot depth labels as the oracle,
    from ``depth_gt`` [B, N, fH, fW] when the batch carries it, else from
    kernel K6 on the points (``points``/``point_mask`` when the caller has
    them on the device already) un-rotated by ``inv(bda_mat)``."""
    imgs, mats = _camera_tensors(batch, device, None)
    oracle = None
    if cfg.use_depth_loss:
        oracle = _key_labels(cfg, batch, device, mats['bda_mat'], points, point_mask,
                             mats['intrin'])
    return dict(imgs=imgs, depth_oracle=oracle, **mats)


def camera_train_inputs(cfg: Config, batch: Dict[str, Any], device,
                        flipped: Optional[torch.Tensor],
                        points: Optional[torch.Tensor] = None,
                        point_mask: Optional[torch.Tensor] = None):
    """The training half of JAX ``_prepare_camera_inputs``: (the camera
    keyword arguments of :class:`BEVDepthLiDAR`, the depth loss's labels
    [B*N, fH, fW, D] float32).

    ``flipped`` [B*S*N] bool (None: no image flipped, the eval step) flips
    each marked image along its width, and the key frame's labels with it:
    the loss compares the flipped prediction with the flipped labels. The
    depth oracle (``use_depth_loss``) is the key frame's *unflipped*
    labels, since the model undoes the flip before the lift (the JAX
    package's documented deviation, JAX :12-17)."""
    imgs, mats = _camera_tensors(batch, device, flipped)
    labels = _key_labels(cfg, batch, device, mats['bda_mat'], points, point_mask,
                         mats['intrin'])
    loss_labels = labels
    if flipped is not None:
        key = flipped.reshape(imgs.shape[:3])[:, 0].reshape(-1)
        loss_labels = torch.where(key[:, None, None, None], labels.flip(-2), labels)
    oracle = labels if cfg.use_depth_loss else None
    return dict(imgs=imgs, flipped=flipped, depth_oracle=oracle, **mats), loss_labels


def loss_and_grads(cfg: Config, model: nn.Module, batch: Dict[str, Any],
                   draws: Optional[Dict[str, Any]] = None, weight_map=None):
    """(loss, gradients in ``named_parameters`` order, {'detection': loss,
    'depth': loss}) of one train-mode forward and backward; updates the
    BatchNorm running statistics in place. A camera model takes ``draws``
    (``flipped`` [B*S*N] bool, ``dropout``: ASPP's keep masks, one [B*N,
    mid, fH, fW] bool a sweep). ``weight_map`` transforms the weights the
    forward runs with (the control's rounding)."""
    device = _device(model)
    targets = _targets(cfg, batch, device)
    points, mask = _points(cfg, batch, device)
    model.train()
    begin_step(model)
    cam: Dict[str, Any] = {}
    labels = None
    if cfg.use_cam:
        cam, labels = camera_train_inputs(cfg, batch, device, draws['flipped'], points, mask)
        cam['dropout'] = draws['dropout']
    params = list(model.parameters())
    weights = _compute_weights(cfg, model, False)
    if weight_map is not None:
        weights = weight_map(weights)
    preds, depth = torch.func.functional_call(
        model, weights,
        (points, mask) if cfg.use_lidar else (None, None),
        dict(cam, return_depth=True))
    det = detection_loss(cfg.get_head_conf(), targets, cast_floating(preds, torch.float32))
    dep = depth_loss_fn(labels, depth) if cfg.use_cam else torch.zeros((), device=device)
    loss = det + dep
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), grads, {'detection': det.detach(), 'depth': dep.detach()}


@torch.no_grad()
def predict(cfg: Config, model: nn.Module, batch: Dict[str, Any]):
    """(boxes, scores, labels, valid) of an eval-mode forward and the decode,
    and the float32 pred maps."""
    device = _device(model)
    model.eval()
    points = mask = None
    if cfg.use_lidar:
        points = _as(batch, 'points', torch.float32, device)
        mask = _as(batch, 'point_mask', torch.bool, device)
    cam = camera_inputs(cfg, batch, device, points, mask) if cfg.use_cam else {}
    preds = model(points, mask, **cam)
    preds = cast_floating(preds, torch.float32)
    return decode_boxes(cfg.get_head_conf(), preds), preds
