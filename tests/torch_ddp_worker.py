"""The cases of ``tests/test_torch_ddp.py``, run by each rank of a gloo world
of CPU processes and, in the test process itself, by one process without a
group on the same global batches.

    python tests/torch_ddp_worker.py RANK WORLD INIT_FILE OUT_FILE [SPEC_FILE]

Each case takes this rank's rows ``[lo, hi)`` of a global batch made from a
seed (``parallel.process_batch_bounds``; all of it without a group) and
returns what the test compares as numpy arrays. The worker imports the port
only: jax, flax and the JAX package are barred from its interpreter.
"""
import dataclasses
import os
import pickle
import sys

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


def step_case(spec_file) -> dict:
    """One train step of this rank on its rows of the pickled global batch
    of ``tests/test_torch_dp_equivalence.py``: the tiny config of its
    modalities at this rank's share of the batch, the pickled starting
    weights, the pickled random draws (flips [B*S*N], ASPP's keep masks
    [B*N, fH, fW, mid] a sweep) sliced to its rows."""
    from mm_training_tpu_torch import parallel
    from mm_training_tpu_torch.configs import tiny_test_config
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.training import create_train_state, make_train_step
    with open(spec_file, 'rb') as f:
        spec = pickle.load(f)
    b = len(spec['batch']['gt_boxes'])
    cfg = tiny_test_config(batch_size=b // parallel.process_count(), **spec['modalities'])
    model = BEVDepthLiDAR(cfg, device='cpu')
    model.load_state_dict(spec['state'])
    state = create_train_state(cfg, model, steps_per_epoch=10)
    lo, hi = _bounds(b)
    draws = None
    if spec['draws'] is not None:
        sn = cfg.num_sweeps * cfg.num_cameras
        draws = {'flipped': torch.from_numpy(spec['draws']['flipped'][lo * sn:hi * sn]),
                 'dropout': [torch.from_numpy(k[lo * cfg.num_cameras:hi * cfg.num_cameras])
                             .permute(0, 3, 1, 2) for k in spec['draws']['dropout']]}
    state, m = make_train_step(cfg)(state, parallel.shard_batch(spec['batch'], 'cpu'), draws)
    return {'metrics': {k: float(v) for k, v in m.items()},
            'params': {n: _np(p) for n, p in model.named_parameters()}}


def start_world(world: int, tmp, spec_file=None):
    """Start ``world`` ranks of this script in ``tmp`` (a rendezvous file
    there, one result file a rank); returns their processes."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS='1')
    extra = [] if spec_file is None else [str(spec_file)]
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         os.path.join(tmp, 'rendezvous'), os.path.join(tmp, f'rank{r}.pkl')] + extra,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]


def finish_world(procs, tmp, timeout=600):
    """Each rank's results, in rank order, once every rank has exited 0;
    raises with every rank's output tail otherwise (one rank's failure
    shows on the others as a collective's error)."""
    outs = []
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError('\n'.join(f'--- rank {i} (rc {p.returncode}) ---\n{o[-3000:]}'
                                       for i, (p, o) in enumerate(zip(procs, outs))))
    results = []
    for r in range(len(procs)):
        with open(os.path.join(tmp, f'rank{r}.pkl'), 'rb') as f:
            results.append(pickle.load(f))
    return results


def main(argv):
    """RANK WORLD INIT_FILE OUT_FILE [SPEC_FILE]: the cases, or with a
    SPEC_FILE :func:`step_case`."""
    rank, world, init_file, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    for banned in ('jax', 'jaxlib', 'flax', 'mm_training_tpu'):
        sys.modules[banned] = None          # any import of them raises ImportError
    torch.set_num_threads(1)
    from mm_training_tpu_torch import parallel
    parallel.initialize(device='cpu', init_method=f'file://{init_file}', world_size=world,
                        rank=rank)
    try:
        results = step_case(argv[4]) if len(argv) > 4 else run_cases()
        results['rank'] = parallel.process_index()
        results['world'] = parallel.process_count()
        with open(out, "wb") as f:
            pickle.dump(results, f)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(sys.argv[1:])
