"""The cases of ``tests/test_torch_ddp.py``, run by each rank of a gloo world
of CPU processes (``parallel/dryrun.py::spawn_ranks``, whose ranks import
the port only: jax, flax and the JAX package are barred from their
interpreters) and, in the test process itself, by one process without a
group on the same global batches.

Each case takes this rank's rows ``[lo, hi)`` of a global batch made from a
seed (``parallel.process_batch_bounds``; all of it without a group) and
returns what the test compares as numpy arrays.
"""
import dataclasses

import numpy as np
import torch

GLOBAL_B = 4
# the global batch of the step cases, and the eval case's validity: with two
# ranks rank 1 holds only padding
STEP_B = 2
EVAL_VALID = (True, False)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _bounds(n):
    from mm_training_tpu_torch import parallel
    return parallel.process_batch_bounds(n)


def narrow(cfg):
    """``cfg`` at the narrow widths of ``tests/torch_port_helpers.py::narrow``."""
    import mm_training_tpu_torch.configs as tcfg
    lconf = dataclasses.replace(
        cfg.get_lidar_conf(),
        encoder_channels=((8, 8, 16), (16, 16, 32), (32, 32, 64), (64, 64)), out_channels=64)
    head = dataclasses.replace(
        cfg.get_head_conf(),
        bev_backbone_conf=tcfg.BEVBackboneConf(in_channels=64, base_channels=32),
        bev_neck_conf=tcfg.BEVNeckConf(in_channels=(32, 64, 128), out_channels=(16, 16, 16)),
        in_channels=48)
    return cfg.replace(lidar_conf=lconf, head_conf=head)


def narrow_cam(cfg):
    """:func:`narrow` plus the narrow camera branch of ``narrow_cam``."""
    import mm_training_tpu_torch.configs as tcfg
    out = narrow(cfg)
    bb = dataclasses.replace(cfg.get_backbone_conf(),
                             img_backbone_conf=tcfg.ImageBackboneConf(depth=10),
                             depth_net_conf=tcfg.DepthNetConf(in_channels=512, mid_channels=32))
    head = out.get_head_conf()
    head = dataclasses.replace(head, bev_backbone_conf=dataclasses.replace(
        head.bev_backbone_conf, in_channels=cfg.fuse_layer_in_channels))
    return out.replace(backbone_conf=bb, head_conf=head)


def bn_case(masked: bool, rows=None) -> dict:
    """A train-mode BatchNorm (plain, or masked with the last two samples'
    mask empty) on a float64 [4, 6, 5, 7] batch: its output, the input
    gradient of a weighted sum of it, the parameter gradients (this rank's
    share) and the new running statistics, of rows ``rows`` (default this
    rank's)."""
    from mm_training_tpu_torch.models.bn_fold import BatchNorm2d, MaskedBatchNorm2d
    rng = np.random.default_rng(11)
    shape = (GLOBAL_B, 6, 5, 7)
    x = rng.standard_normal(shape) * 2.0 + 3.0
    w = rng.standard_normal(shape)
    mask = rng.random((GLOBAL_B, 1, 5, 7)) < 0.5
    mask[2:] = False
    bn = (MaskedBatchNorm2d(6) if masked else BatchNorm2d(6, relu=True)).double().train()
    with torch.no_grad():
        for p in (bn.weight, bn.bias, bn.running_mean):
            p.copy_(torch.from_numpy(rng.standard_normal(6)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6)))
    lo, hi = rows or _bounds(GLOBAL_B)
    xt = torch.from_numpy(x[lo:hi]).requires_grad_()
    y = bn(xt, torch.from_numpy(mask[lo:hi])) if masked else bn(xt)
    (y * torch.from_numpy(w[lo:hi])).sum().backward()
    return {'y': _np(y), 'dx': _np(xt.grad), 'dweight': _np(bn.weight.grad),
            'dbias': _np(bn.bias.grad), 'running_mean': _np(bn.running_mean),
            'running_var': _np(bn.running_var)}


def detection_inputs(objects):
    """(head conf, targets, float32 NHWC preds) of the global batch whose
    objects are ``objects`` [(sample, label), ...] (a car is label 0, a
    pedestrian 8), the rest of its slots empty."""
    from mm_training_tpu_torch.configs import tiny_test_config
    from mm_training_tpu_torch.models.centerpoint_head import get_targets
    conf = tiny_test_config(use_cam=False).get_head_conf()
    rng = np.random.default_rng(12)
    k = 4
    boxes = np.zeros((GLOBAL_B, k, 9), np.float32)
    labels = np.zeros((GLOBAL_B, k), np.int64)
    gmask = np.zeros((GLOBAL_B, k), bool)
    for j, (b, label) in enumerate(objects):
        boxes[b, j] = (rng.uniform(-20, 20), rng.uniform(-10, 10), 0.0, 4.0, 2.0, 1.5,
                       rng.uniform(-3, 3), 0.0, 0.0)
        labels[b, j] = label
        gmask[b, j] = True
    targets = get_targets(conf, torch.from_numpy(boxes), torch.from_numpy(labels),
                          torch.from_numpy(gmask))
    preds = []
    for hm in targets[0]:
        _, c, h, w = hm.shape
        preds.append({name: torch.from_numpy(rng.standard_normal((GLOBAL_B, h, w, ch))
                                             .astype(np.float32))
                      for name, ch in (('heatmap', c), ('reg', 2), ('height', 1), ('dim', 3),
                                       ('rot', 2), ('vel', 2))})
    return conf, targets, preds


def detection_case(objects, rows=None) -> dict:
    """``detection_loss`` of rows ``rows`` (default this rank's) and its
    gradient with respect to those rows' heatmap logits."""
    from mm_training_tpu_torch.models.centerpoint_head import detection_loss
    conf, targets, preds = detection_inputs(objects)
    lo, hi = rows or _bounds(GLOBAL_B)
    mine = [{k: v[lo:hi].clone().requires_grad_(k == 'heatmap') for k, v in p.items()}
            for p in preds]
    loss = detection_loss(conf, [[t[lo:hi] for t in part] for part in targets], mine)
    loss.backward()
    return {'loss': _np(loss), 'dheatmap': [_np(p['heatmap'].grad) for p in mine]}


def depth_inputs():
    """Depth labels [8, 3, 4, 10] (B=4 of 2 cameras) with one foreground
    pixel in the whole batch, in sample 0, and random depth distributions."""
    rng = np.random.default_rng(13)
    labels = np.zeros((2 * GLOBAL_B, 3, 4, 10), np.float32)
    labels[1, 2, 3, 6] = 1.0
    logits = rng.standard_normal((2 * GLOBAL_B, 10, 3, 4))
    return labels, np.exp(logits) / np.exp(logits).sum(1, keepdims=True)


def depth_case(rows=None) -> dict:
    from mm_training_tpu_torch.training.train_step import depth_loss_fn
    labels, preds = depth_inputs()
    lo, hi = rows or _bounds(GLOBAL_B)
    p = torch.from_numpy(preds[2 * lo:2 * hi]).requires_grad_()
    loss = depth_loss_fn(torch.from_numpy(labels[2 * lo:2 * hi]), p)
    loss.backward()
    return {'loss': _np(loss), 'dpreds': _np(p.grad)}


def _train_setup(camera: bool):
    """(config of a rank's rows, a float64 model, the global batch of
    ``STEP_B``) of the tiny L+R (``camera``: L+R+C) train case."""
    from mm_training_tpu_torch import parallel
    from mm_training_tpu_torch.configs import tiny_test_config
    from mm_training_tpu_torch.data import make_fake_batch, random_bda_matrices
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    cfg = tiny_test_config(use_cam=camera, use_radar=True, batch_size=STEP_B)
    cfg = narrow_cam(cfg) if camera else narrow(cfg)
    batch = make_fake_batch(cfg, seed=3)
    if camera:
        batch['bda_mat'] = random_bda_matrices(STEP_B, seed=7)
    model = BEVDepthLiDAR(cfg, device='cpu', generator=torch.Generator().manual_seed(4))
    rank_cfg = cfg.replace(batch_size=STEP_B // parallel.process_count())
    return rank_cfg, model.to(torch.float64), batch


def train_case(camera: bool) -> dict:
    """One float64 train step of a rank on its rows of the global batch (the
    camera's random flips and dropout from the step's own generator): its
    metrics, the all-reduces it made, then Adam's first moments, the
    parameters and the buffers after it."""
    from mm_training_tpu_torch import parallel
    from mm_training_tpu_torch.training import create_train_state, make_train_step
    cfg, model, batch = _train_setup(camera)
    state = create_train_state(cfg, model, steps_per_epoch=10)
    step = make_train_step(cfg)
    metrics = []
    parallel.reset_counts()
    state, m = step(state, parallel.shard_batch(batch, 'cpu'))
    metrics.append({k: float(v) for k, v in m.items()})
    names = [n for n, _ in model.named_parameters()]
    return {'metrics': metrics, 'counts': dict(parallel.COUNTS),
            'lr': state.optimizer.schedule(0),
            'mu': {n: _np(m) for n, m in zip(names, state.optimizer.mu)},
            'params': {n: _np(p) for n, p in model.named_parameters()},
            'buffers': {n: _np(b) for n, b in model.named_buffers()}}


def eval_case() -> dict:
    """The tiny L+R eval step (float64 weights) on a global batch whose
    second sample is padding, and the BEV mAP of the valid rows' boxes pooled
    over the ranks with ``all_gather_object``: the decoded boxes, and
    (boxes near the ground truth, so that the AP is not 0) for the pooling."""
    from mm_training_tpu_torch import parallel
    from mm_training_tpu_torch.evaluation import MAPCalculator
    from mm_training_tpu_torch.training import create_train_state, make_eval_step
    cfg, model, batch = _train_setup(False)
    state = create_train_state(cfg, model, steps_per_epoch=10)
    batch = dict(batch, sample_valid=np.asarray(EVAL_VALID))
    lo, hi = _bounds(STEP_B)
    metrics, (boxes, scores, labels, valid), _ = make_eval_step(cfg)(
        state, parallel.shard_batch(batch, 'cpu'))
    rng = np.random.default_rng(14)
    calc = MAPCalculator()
    for b in range(lo, hi):
        if not EVAL_VALID[b]:
            continue
        gm = batch['gt_mask'][b]
        gt = batch['gt_boxes'][b][gm].astype(np.float64)
        pred = gt + rng.normal(0.0, 0.3, gt.shape) * (np.arange(9) < 2)
        calc.update([[gt, batch['gt_labels'][b][gm]]],
                    [[pred, rng.uniform(0.1, 1.0, len(gt)), batch['gt_labels'][b][gm]]])
    pooled = parallel.all_gather_object((calc.gts, calc.preds, calc.img_names))
    calc.reset()
    for gts, preds, names in pooled:
        calc.update(gts, preds, names)
    bev = calc.compute_bev(iou_thr=0.3, x_range=cfg.point_cloud_range[3])
    return {'metrics': {k: float(v) for k, v in metrics.items()},
            'boxes': _np(boxes), 'scores': _np(scores), 'labels': _np(labels),
            'valid': _np(valid), 'map': {k: float(v) for k, v in bev.items()}}


ONE_POSITIVE = ((0, 0),)                                  # one car, in sample 0
UNEVEN = ((0, 0), (0, 0), (1, 8), (3, 0))                 # 3 objects in rows 0-1, 1 in 2-3


def run_cases() -> dict:
    """Every case, in one order on every rank."""
    torch.manual_seed(0)
    return {'bn_plain': bn_case(False), 'bn_masked': bn_case(True),
            'det_one_positive': detection_case(ONE_POSITIVE),
            'det_uneven': detection_case(UNEVEN), 'depth_one_fg': depth_case(),
            'train_lidar': train_case(False), 'train_camera': train_case(True),
            'eval_padded': eval_case()}


def rank_cases() -> dict:
    """:func:`run_cases` on a rank, with its rank and world."""
    from mm_training_tpu_torch import parallel
    return dict(run_cases(), rank=parallel.process_index(), world=parallel.process_count())
