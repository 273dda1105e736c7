"""Train, eval and predict steps.

The port of ``mm_training_tpu/training/train_step.py``: ``TrainState`` and
``create_train_state``, ``make_train_step`` (JAX :183-257),
``make_train_step_multi`` (:278-300), ``_eval_weights`` (:303-308),
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

A batch's arrays may be numpy (copied to the model's device by the step)
or tensors on that device already (the trainer's pinned, non-blocking
copies: ``training/trainer.py::_device_batches``).

With ``use_ema`` the state carries an EMA shadow of the model's state dict
(``training/ema.py``), updated after each step's optimizer update and BN
statistics, and eval and predict run on it (``_eval_weights``). With
``use_tta`` eval and predict run the 4-way flip ensemble
(``training/tta.py``), the depth oracle computed once from the unflipped
points.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .. import parallel
from ..configs import Config
from ..models import BEVDepthLiDAR, decode_boxes
from ..models.bev_depth import sharded_parameters
from ..models.bn_fold import begin_step
from ..models.centerpoint_head import detection_loss, get_targets, targets_on_columns
from ..ops import depth_labels as depth_label_ops
from ..parallel import spatial
from .ema import ema_update
from .optim import AdamW, make_optimizer
from .tta import tta_forward

__all__ = ['HOST_FIELDS', 'IMAGENET_MEAN', 'IMAGENET_STD', 'TrainState', 'camera_inputs',
           'camera_train_inputs', 'cast_floating', 'create_train_state', 'depth_loss_fn',
           'draw_train_randoms', 'loss_and_grads', 'make_eval_step', 'make_predict_step',
           'make_state_predict_step', 'make_train_step', 'make_train_step_multi',
           'normalize_images']

# a batch's host-only entries (the loader's), never read by a step
HOST_FIELDS = ('path', 'n_valid', 'n_valid_global')
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
    master parameters and BatchNorm statistics), its optimizer and, with
    ``use_ema``, the EMA shadow: copies of every entry of the model's
    ``state_dict()`` in its dtype (the JAX ``ema_params`` and
    ``ema_batch_stats``), keyed as there."""
    step: int
    model: BEVDepthLiDAR
    optimizer: AdamW
    ema: Optional[Dict[str, torch.Tensor]] = None


def create_train_state(cfg: Config, model: BEVDepthLiDAR, steps_per_epoch: int = 1000,
                       global_batch_scale: Optional[int] = None) -> TrainState:
    """Step 0 with :func:`~mm_training_tpu_torch.training.optim.make_optimizer`
    over the model's parameters (in ``named_parameters`` order); with
    ``use_ema`` the shadow starts as a copy of the model's state.
    ``global_batch_scale`` defaults to the data-parallel size: ``batch_size``
    counts a data rank's samples, and the learning rate follows the global
    batch (JAX ``trainer.py:168-176``); model peers share their rows, so
    scaling by the world would train at ``model_parallel`` x that rate.
    Raises unless ``cfg.model_parallel`` is the current mesh's
    (``parallel.check_layout``), as the step builders do."""
    parallel.check_layout(cfg.model_parallel)
    if global_batch_scale is None:
        global_batch_scale = parallel.data_parallel_size()
    opt = make_optimizer(cfg, model.parameters(), steps_per_epoch, global_batch_scale)
    ema = None
    if cfg.use_ema:
        ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return TrainState(step=0, model=model, optimizer=opt, ema=ema)


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
    return 3.0 * per_px.sum() / parallel.all_reduce_sum(parallel.once(fg.sum())).clamp_min(1.0)


def draw_train_randoms(cfg: Config, imgs_shape, generator: torch.Generator,
                       device, rows: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
    """A camera train step's random draws for images [B, S, N, ...] from
    ``generator`` (on ``device``): ``flipped`` [B*S*N] bool, each image
    flipped with probability 0.5 (JAX :124), and ``dropout``, ASPP's keep
    masks, one [B*N, mid, fH, fW] bool a sweep (channels-last memory, the
    activations' layout), each element kept with probability 0.5 (JAX
    ``nn.Dropout(0.5)``). Not the JAX package's bits: its tests pass JAX's
    draws instead.

    With ``rows`` (lo, hi) the draws are those of the whole batch of B
    samples and only samples [lo, hi) of them are kept: a data-parallel
    rank, its generator seeded as every rank's, draws what one process
    would draw for the global batch and takes its own rows (``flipped`` is
    ordered by sample, sweep, camera; ``dropout`` by sample, camera)."""
    b, s, n = imgs_shape[:3]
    lo, hi = (0, b) if rows is None else rows
    bb = cfg.get_backbone_conf()
    mid, (fh, fw) = bb.depth_net_conf.mid_channels, bb.feat_hw
    flipped = torch.rand(b * s * n, generator=generator, device=device) < 0.5
    keep = [(torch.rand(b * n, fh, fw, mid, generator=generator, device=device) < 0.5
             )[lo * n:hi * n].permute(0, 3, 1, 2) for _ in range(s)]
    return {'flipped': flipped[lo * s * n:hi * s * n], 'dropout': keep}


def loss_and_grads(cfg: Config, state: TrainState, batch: Dict[str, Any],
                   draws: Optional[Dict[str, Any]] = None):
    """One forward and backward in train mode: (loss, gradients in
    ``named_parameters`` order (float32 masters), {'detection': loss,
    'depth': loss}). The loss is the detection loss plus, with the camera,
    the depth loss. Updates the BatchNorm running statistics in place. A
    camera model takes ``draws`` (:func:`draw_train_randoms`) for the
    batch's rows.

    In a process group (``parallel``) ``batch`` is this rank's rows of the
    global batch; the BatchNorm statistics and the loss normalizers are the
    global batch's, each rank's loss is its rows' share, and the gradients
    and losses returned are summed over the ranks (the gradients in flat
    buckets, one all-reduce each): every rank returns what one process
    returns on the global batch. On a model axis the head's loss and
    gradients are this rank's W shard's share; the encoders' and the
    fusion's gradients and the depth loss, which the model peers compute
    alike, are model index 0's (``parallel.once``) in the sum."""
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
    axis = parallel.model_axis()
    if axis is not None:
        targets = targets_on_columns(targets, *spatial.columns(targets[0][0].shape[-1], axis))
    det = detection_loss(cfg.get_head_conf(), targets, cast_floating(preds, torch.float32))
    dep = depth_loss_fn(labels, depth) if cfg.use_cam else torch.zeros((), device=device)
    loss = det + dep
    grads = torch.autograd.grad(loss, params)
    if axis is not None and axis.index:
        grads = [g if head else torch.zeros_like(g)
                 for g, head in zip(grads, sharded_parameters(model))]
    grads = parallel.all_reduce_buckets(grads)
    if parallel.active():
        dep = parallel.once(dep)
        loss, det, dep = parallel.all_reduce_sum(torch.stack([det + dep, det, dep]).detach())
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
    clipped AdamW update of the float32 masters; with ``use_ema`` and a
    shadow in the state, the EMA update of the shadow from the stored
    masters and BN statistics (JAX :244-250), at the post-increment step.
    A camera step's random draws are ``draws`` when given, else drawn from
    a generator the step owns, made on the model's device and seeded with
    ``cfg.seed``; in a process group each rank draws for the global batch
    and keeps its rows (:func:`draw_train_randoms`). The state is updated
    in place (the JAX step donates its input) and returned with ``step +
    1``; ``metrics`` holds
    ``train_loss``, ``train_detection_loss``, ``train_depth_loss`` (0
    without the camera) and ``grad_norm`` (before clipping) as 0-dim
    tensors on the device, read without a host wait."""
    parallel.check_layout(cfg.model_parallel)
    own = {}

    def train_step(state: TrainState, batch: Dict[str, Any],
                   draws: Optional[Dict[str, Any]] = None):
        if cfg.use_cam and draws is None:
            device = _device(state.model)
            gen = own.setdefault(device, torch.Generator(device=device).manual_seed(cfg.seed))
            shape = tuple(batch['imgs'].shape)
            dp = parallel.data_parallel_size()
            draws = draw_train_randoms(cfg, (shape[0] * dp,) + shape[1:], gen, device,
                                       parallel.process_batch_bounds(shape[0] * dp))
        loss, grads, parts = loss_and_grads(cfg, state, batch, draws)
        grad_norm = state.optimizer.step(grads)
        state.step += 1
        if cfg.use_ema and state.ema is not None:
            ema_update(state.ema, state.model.state_dict(), state.step, cfg.ema_decay)
        metrics = {'train_loss': loss, 'train_detection_loss': parts['detection'],
                   'train_depth_loss': parts['depth'], 'grad_norm': grad_norm}
        return state, metrics

    return train_step


def make_train_step_multi(cfg: Config, k: int
                          ) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``train_step_multi(state, batches) -> (state, metrics)``: ``k``
    train steps in order on batches stacked on a leading axis ([k, B, ...],
    ``training/loader.py::stack_batches``), each through
    :func:`make_train_step`; every metric is its mean over the ``k`` steps,
    as the JAX package's ``lax.scan`` returns them. On the TPU this cut the
    host's round trips a step; here it is the same K sequential steps."""
    step = make_train_step(cfg)

    def train_step_multi(state: TrainState, batches: Dict[str, Any]):
        metrics = []
        for i in range(k):
            state, m = step(state, {key: v[i] for key, v in batches.items()
                                    if key not in HOST_FIELDS})
            metrics.append(m)
        return state, {name: torch.stack([m[name] for m in metrics]).mean()
                       for name in metrics[0]}

    return train_step_multi


def _eval_weights(cfg: Config, state: TrainState) -> Dict[str, torch.Tensor]:
    """The tensors eval and predict run the model with: the EMA shadow when
    ``use_ema`` and the state holds one (the reference's dormant
    EMACallback saves them for exactly this), else the masters; their
    floating entries, bf16 copies under ``precision == 'bf16'``."""
    if cfg.use_ema and state.ema is not None:
        named = {k: v for k, v in state.ema.items() if v.is_floating_point()}
        if cfg.precision != 'bf16':
            return named
        return {k: v.to(torch.bfloat16) for k, v in named.items()}
    return _compute_weights(cfg, state.model, True)


def _forward(cfg: Config, model: nn.Module, weights: Optional[Dict[str, torch.Tensor]],
             points: Optional[torch.Tensor], mask: Optional[torch.Tensor],
             cam: Dict[str, Any], return_depth: bool = True):
    """(float32 preds, depth or None) of an eval-mode forward of ``model``
    (through ``functional_call`` on ``weights`` when given), the 4-way flip
    ensemble under ``use_tta``; on a model axis the whole maps, gathered
    from the model peers' W shards."""
    if not cfg.use_lidar:
        points = mask = None
    if cfg.use_tta:
        return tta_forward(model, weights, points, mask, cam, return_depth)
    kw = dict(cam, return_depth=return_depth)
    if weights is None:
        out = model(points, mask, **kw)
    else:
        out = torch.func.functional_call(model, weights, (points, mask), kw)
    preds, depth = out if return_depth else (out, None)
    preds = spatial.gather_w(preds, parallel.model_axis())
    return cast_floating(preds, torch.float32), depth


def make_eval_step(cfg: Config) -> Callable:
    """``eval_step(state, batch) -> (metrics, (boxes, scores, labels, valid),
    viz)``: forward in eval mode on :func:`_eval_weights` (bf16 casts under
    ``precision == 'bf16'``; no image flipped; the flip ensemble under
    ``use_tta``), the detection loss and, with the camera, the depth loss, both with the
    batch's optional ``sample_valid`` [B] mask (in a process group the losses
    of the global batch, the same on every rank), decode with circle NMS of
    the batch's rows.
    ``metrics``: ``detection_loss``, ``depth_loss`` (0 without the camera),
    ``loss``; ``viz``: ``heatmaps`` [T, H, W], each task's max-class heatmap
    of the first sample in sigmoid space, and with the camera ``depth`` [fH,
    fW, D] float32, the first camera's depth distribution."""
    parallel.check_layout(cfg.model_parallel)
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
        preds, depth = _forward(cfg, model, _eval_weights(cfg, state), points, mask, cam)
        sample_valid: Optional[torch.Tensor] = None
        if 'sample_valid' in batch:
            sample_valid = _as(batch, 'sample_valid', torch.bool, device)
        targets, mine = _targets(cfg, batch, device), preds
        axis = parallel.model_axis()
        if axis is not None:       # the loss of this rank's columns
            targets = targets_on_columns(targets, *spatial.columns(
                targets[0][0].shape[-1], axis))
            mine = spatial.local_w(preds, axis)
        det = detection_loss(head_conf, targets, mine, sample_mask=sample_valid)
        dep = (depth_loss_fn(labels, depth, sample_mask=sample_valid) if cfg.use_cam
               else torch.zeros((), device=device))
        if parallel.active():
            det, dep = parallel.all_reduce_sum(torch.stack([det, parallel.once(dep)]))
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


def _predict(cfg: Config, model: nn.Module, weights: Optional[Dict[str, torch.Tensor]],
             batch: Dict[str, Any]) -> Tuple[torch.Tensor, ...]:
    """Forward (the flip ensemble under ``use_tta``) + decode of a request."""
    device = _device(model)
    points = mask = None
    if cfg.use_lidar:
        points = _as(batch, 'points', torch.float32, device)
        mask = _as(batch, 'point_mask', torch.bool, device)
    cam = camera_inputs(cfg, batch, device, points, mask) if cfg.use_cam else {}
    preds, _ = _forward(cfg, model, weights, points, mask, cam, return_depth=False)
    return decode_boxes(cfg.get_head_conf(), preds)


def make_predict_step(cfg: Config, model: BEVDepthLiDAR
                      ) -> Callable[[Dict[str, Any]], Tuple[torch.Tensor, ...]]:
    """Forward + decode only (predict_step, mm_training_aim.py:344-369).

    The returned ``predict_step(batch)`` takes a request batch (numpy arrays
    or tensors: ``points`` [B, P, F] and ``point_mask`` [B, P] with the
    LiDAR; ``imgs`` uint8 [B, S, N, H, W, 3], ``sensor2ego``, ``intrin``,
    ``extrinsics`` [B, S, N, 4, 4] and ``bda_mat`` [B, 4, 4] with the
    camera) and returns (boxes [B, T*83, 9], scores, labels, valid) on the
    model's device. The model's weights are cast once, here (a bf16 copy
    under ``precision == 'bf16'``); ``use_tta`` runs the flip ensemble, its
    depth oracle made once from the unflipped points."""
    parallel.check_layout(cfg.model_parallel)
    net = cast_floating(model, torch.bfloat16) if cfg.precision == 'bf16' else model
    net.eval()

    @torch.inference_mode()
    def predict_step(batch: Dict[str, Any]) -> Tuple[torch.Tensor, ...]:
        return _predict(cfg, net, None, batch)

    return predict_step


def make_state_predict_step(cfg: Config
                            ) -> Callable[[TrainState, Dict[str, Any]], Tuple[torch.Tensor, ...]]:
    """``predict_step(state, batch) -> (boxes, scores, labels, valid)``:
    :func:`make_predict_step`'s forward and decode on a train state's
    :func:`_eval_weights` (the EMA shadow under ``use_ema``), as the JAX
    package's ``make_predict_step`` takes its state; the trainer's
    ``predict`` calls it."""
    parallel.check_layout(cfg.model_parallel)

    @torch.no_grad()     # not inference_mode: BatchNorm's s, t cache reads versions
    def predict_step(state: TrainState, batch: Dict[str, Any]) -> Tuple[torch.Tensor, ...]:
        state.model.eval()
        return _predict(cfg, state.model, _eval_weights(cfg, state), batch)

    return predict_step
