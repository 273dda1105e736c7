"""Train, eval and predict steps.

The port of ``mm_training_tpu/training/train_step.py``: ``TrainState`` and
``create_train_state``, ``make_train_step`` (JAX :183-257),
``make_eval_step`` (:311-367), ``make_predict_step`` (:369-398),
``cast_floating`` (:148-154), ``normalize_images`` (:74-81),
``_prepare_camera_inputs`` (:84-145: depth labels from a precomputed
``depth_gt`` or from kernel K6 on the points un-rotated by inv(BDA), the
random horizontal flip of images and labels, the key frame's flipped labels
for the loss and its unflipped labels as the depth oracle when
``use_depth_loss``) and ``depth_loss_fn`` (:157-173). Every step serves
every modality: LiDAR, LiDAR+radar, the camera alone and fused with them.

A camera train step's random draws are the image flips [B*S*N] (JAX :124)
and ASPP's dropout keep masks (one [B*N, mid, fH, fW] a sweep, JAX
``models/depth_net.py:133``). The step draws them from a ``torch.Generator``
it owns (:func:`draw_train_randoms`), or the caller passes them in, as the
parity tests pass the JAX package's draws.

Mixed precision is the JAX step's cast, not autocast: with
``cfg.precision == 'bf16'`` the float32 master parameters are cast to bf16
inside the differentiated function (``torch.func.functional_call`` on the
cast copies), so every layer computes in bf16 and the gradients reach the
float32 masters; the pred maps and the depth go back to float32 before the
losses. Train-mode BatchNorm updates the float32 master statistics in
place (rounding the old ones to bf16 once a step first, as the JAX step's
cast of ``batch_stats`` does). Eval and predict cast the statistics too.

EMA weights (``use_ema``) and ``make_train_step_multi`` (K steps a dispatch)
arrive with the runtime slice and are refused until then.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..configs import Config
from ..models import BEVDepthLiDAR, decode_boxes
from ..models.bn_fold import begin_step
from ..models.centerpoint_head import detection_loss, get_targets
from ..ops import depth_labels as depth_label_ops
from .optim import AdamW, make_optimizer

__all__ = ['IMAGENET_MEAN', 'IMAGENET_STD', 'TrainState', 'camera_inputs',
           'camera_train_inputs', 'cast_floating', 'create_train_state', 'depth_loss_fn',
           'draw_train_randoms', 'loss_and_grads', 'make_eval_step', 'make_predict_step',
           'make_train_step', 'normalize_images']

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
    exactly. Plain torch: the JAX package leaves it to XLA."""
    d = depth_labels.shape[-1]
    t = depth_labels.reshape(-1, d)
    p = depth_preds.float().permute(0, 2, 3, 1).reshape(-1, d).clamp(1e-7, 1 - 1e-7)
    fg = (t.amax(1) > 0.0).to(p.dtype)
    if sample_mask is not None:
        fg = fg * sample_mask.to(p.dtype).repeat_interleave(fg.shape[0] // sample_mask.shape[0])
    bce = -(t * torch.log(p) + (1 - t) * torch.log(1 - p))
    per_px = bce.sum(-1) * fg
    return 3.0 * per_px.sum() / fg.sum().clamp_min(1.0)


def draw_train_randoms(cfg: Config, imgs_shape, generator: torch.Generator,
                       device) -> Dict[str, Any]:
    """A camera train step's random draws for images [B, S, N, ...] from
    ``generator`` (on ``device``): ``flipped`` [B*S*N] bool, each image
    flipped with probability 0.5 (JAX :124), and ``dropout``, ASPP's keep
    masks, one [B*N, mid, fH, fW] bool a sweep (channels-last memory, the
    activations' layout), each element kept with probability 0.5 (JAX
    ``nn.Dropout(0.5)``). Not the JAX package's bits: its tests pass JAX's
    draws instead."""
    b, s, n = imgs_shape[:3]
    bb = cfg.get_backbone_conf()
    mid, (fh, fw) = bb.depth_net_conf.mid_channels, bb.feat_hw
    flipped = torch.rand(b * s * n, generator=generator, device=device) < 0.5
    keep = [(torch.rand(b * n, fh, fw, mid, generator=generator, device=device) < 0.5
             ).permute(0, 3, 1, 2) for _ in range(s)]
    return {'flipped': flipped, 'dropout': keep}


def loss_and_grads(cfg: Config, state: TrainState, batch: Dict[str, Any],
                   draws: Optional[Dict[str, Any]] = None):
    """One forward and backward in train mode: (loss, gradients in
    ``named_parameters`` order (float32 masters), {'detection': loss,
    'depth': loss}). The loss is the detection loss plus, with the camera,
    the depth loss. Updates the BatchNorm running statistics in place. A
    camera model takes ``draws`` (:func:`draw_train_randoms`)."""
    model = state.model
    device = _device(model)
    targets = _targets(cfg, batch, device)
    points, mask = _points(cfg, batch, device)
    model.train()
    begin_step(model)
    cam: Dict[str, Any] = {}
    if cfg.use_cam:
        if draws is None:
            raise ValueError('a camera train step takes its random draws (flipped, dropout; '
                             'draw_train_randoms)')
        cam, labels = camera_train_inputs(cfg, batch, device, draws['flipped'], points, mask)
        cam['dropout'] = draws['dropout']
    params = list(model.parameters())
    preds, depth = torch.func.functional_call(
        model, _compute_weights(cfg, model, False),
        (points, mask) if cfg.use_lidar else (None, None),
        dict(cam, return_depth=True))
    det = detection_loss(cfg.get_head_conf(), targets, cast_floating(preds, torch.float32))
    dep = depth_loss_fn(labels, depth) if cfg.use_cam else torch.zeros((), device=device)
    loss = det + dep
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), grads, {'detection': det.detach(), 'depth': dep.detach()}


def make_train_step(cfg: Config) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``train_step(state, batch, draws=None) -> (state, metrics)``.

    ``batch``: numpy arrays or tensors with ``gt_boxes`` [B, K, 9],
    ``gt_labels`` [B, K], ``gt_mask`` [B, K]; with the LiDAR ``points`` [B,
    P, F] and ``point_mask`` [B, P]; with the camera ``imgs`` uint8 [B, S, N,
    H, W, 3], ``sensor2ego``, ``intrin``, ``extrinsics`` [B, S, N, 4, 4],
    ``bda_mat`` [B, 4, 4] and ``depth_gt`` [B, N, fH, fW] or the points.
    Targets (kernel K2), the camera's labels and flips, the forward in train
    mode, the detection loss plus the depth loss, their gradients, then the
    clipped AdamW update of the float32 masters. A camera step's random
    draws are ``draws`` when given, else drawn from a generator the step
    owns, made on the model's device and seeded with ``cfg.seed``.
    The state is updated in place (the JAX step donates its input) and
    returned with ``step + 1``; ``metrics`` holds ``train_loss``,
    ``train_detection_loss``, ``train_depth_loss`` (0 without the camera)
    and ``grad_norm`` (before clipping) as 0-dim tensors on the device,
    read without a host wait."""
    if cfg.use_ema:
        raise NotImplementedError('EMA weights (use_ema) arrive with the runtime '
                                  'slice (slice 5) of the port')
    own = {}

    def train_step(state: TrainState, batch: Dict[str, Any],
                   draws: Optional[Dict[str, Any]] = None):
        if cfg.use_cam and draws is None:
            device = _device(state.model)
            gen = own.setdefault(device, torch.Generator(device=device).manual_seed(cfg.seed))
            draws = draw_train_randoms(cfg, batch['imgs'].shape, gen, device)
        loss, grads, parts = loss_and_grads(cfg, state, batch, draws)
        grad_norm = state.optimizer.step(grads)
        state.step += 1
        metrics = {'train_loss': loss, 'train_detection_loss': parts['detection'],
                   'train_depth_loss': parts['depth'], 'grad_norm': grad_norm}
        return state, metrics

    return train_step


def make_eval_step(cfg: Config) -> Callable:
    """``eval_step(state, batch) -> (metrics, (boxes, scores, labels, valid),
    viz)``: forward in eval mode (bf16 casts of the parameters and
    statistics under ``precision == 'bf16'``; no image flipped), the
    detection loss and, with the camera, the depth loss, both with the
    batch's optional ``sample_valid`` [B] mask, decode with circle NMS.
    ``metrics``: ``detection_loss``, ``depth_loss`` (0 without the camera),
    ``loss``; ``viz``: ``heatmaps`` [T, H, W], each task's max-class heatmap
    of the first sample in sigmoid space, and with the camera ``depth`` [fH,
    fW, D] float32, the first camera's depth distribution."""
    head_conf = cfg.get_head_conf()

    @torch.no_grad()     # not inference_mode: BatchNorm's s, t cache reads versions
    def eval_step(state: TrainState, batch: Dict[str, Any]):
        model = state.model
        device = _device(model)
        model.eval()
        points, mask = _points(cfg, batch, device)
        cam: Dict[str, Any] = {}
        if cfg.use_cam:
            cam, labels = camera_train_inputs(cfg, batch, device, None, points, mask)
        preds, depth = torch.func.functional_call(
            model, _compute_weights(cfg, model, True),
            (points, mask) if cfg.use_lidar else (None, None),
            dict(cam, return_depth=True))
        preds = cast_floating(preds, torch.float32)
        sample_valid: Optional[torch.Tensor] = None
        if 'sample_valid' in batch:
            sample_valid = _as(batch, 'sample_valid', torch.bool, device)
        det = detection_loss(head_conf, _targets(cfg, batch, device), preds,
                             sample_mask=sample_valid)
        dep = (depth_loss_fn(labels, depth, sample_mask=sample_valid) if cfg.use_cam
               else torch.zeros((), device=device))
        viz = {'heatmaps': torch.stack([torch.sigmoid(p['heatmap'][0].amax(-1))
                                        for p in preds])}
        if depth is not None:
            viz['depth'] = depth[0].permute(1, 2, 0).float()
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
