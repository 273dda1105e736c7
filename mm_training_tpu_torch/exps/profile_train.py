"""Where a training step's time goes on the card (torch.profiler).

Builds a full-width model (``--config``: ``lidar_radar``, grid 256 x 2048,
100k 8-feature points a frame; or ``lidar_cam_radar``, the same LiDAR branch
plus four 704 x 1280 cameras through ResNet-50, the DepthNet and the
lift-splat, with a rotated BEV augmentation, the step's random flips and
ASPP's dropout) in bf16 compute over float32 masters with seeded random
weights, runs ``--warmup`` train steps on one fixed fake batch, then
profiles ``--steps`` steps and prints: host wall time per step, device time
per step summed over kernels, the device's busy share (device time / wall
time), device ops per step, peak device memory, the kernels and host ops
that take the most time, and the device time a step of each of the port's
own kernels (by kernel name). Before the profiled window it times
``--steps`` unprofiled steps (host clock, each ending in a synchronize).
With the camera it also times the depth loss alone, forward and backward
at the step's shapes (plain torch: the JAX package leaves it to XLA); at
B=4 it prints the step's numbers on the tree before the fused DCN backward
beside its own (``BEFORE``). ``--raw-rig`` runs the camera model on the
general splat (kernels K8 and K8') with every camera of the fake rig
pitched by 3 degrees.

    python -m mm_training_tpu_torch.exps.profile_train [--config lidar_cam_radar]
        [--raw-rig] [--cameras 2] [--batch-size 4] [--steps 10] [--warmup 3]
        [--trace train_trace.json]

``--cameras`` sets the fake rig's camera count (the config's
``num_cameras``, 4 by default): an aiMotive tree gives 2 (front and back)
unless its fisheyes are virtualized.

``--ops-only`` prints only the device operations of one step after the
warm-up (``exps/timing.py::device_ops``), as one JSON line.

``--sparse-import`` trains the sparse-import LiDAR encoder on LiDAR-like
points; with ``--beside-dense`` the dense encoder's step on the same batch
runs beside it, the two step p50s taken in alternating rounds in one
process, with each step's device ms and device ops.

``--one-rank-group`` runs the step as the one rank of an NCCL process group
(``parallel/``: the BN statistics, normalizers, gradients and losses
all-reduced over the group of one) and adds the all-reduces a step and their
bytes; the same command without it gives the plain step to set beside it.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .. import parallel
from ..configs import raw_rig, variants
from ..data import make_fake_batch, random_bda_matrices
from ..models import BEVDepthLiDAR
from ..training import TrainState, create_train_state, depth_loss_fn, make_train_step
from .kernel_inputs import sparse_import, with_lidar_like_points
from .timing import device_ms, device_ops

__all__ = ['KERNEL_NAMES', 'RAW_RIG_PITCH_DEG', 'benchmark_train', 'depth_loss_ms', 'main',
           'train_batch']

# the port's kernels by a substring of their device names (csrc/*.cu)
KERNEL_NAMES = {
    'A affine_act': 'affine_act_kernel', "A' affine_act_backward": 'affine_act_bwd',
    'K1 pillar_encoder_input': 'pillar_kernel', 'K1 sparse_encoder_input': 'sparse_kernel',
    'K2 draw_heatmap': 'heatmap_kernel',
    'K3 circle_nms': 'circle_nms', 'K4 lift_splat': 'lift_splat_kernel',
    "K4' lift_splat_backward": 'lift_splat_bwd', 'K5 deform_conv3x3': 'deform_conv_kernel',
    'K5 columns deform_sample': 'deform_sample_kernel', "K5' deform_conv3x3_backward":
    'deform_bwd', 'K6 depth_labels': 'depth_labels_kernel', 'K7 bev_warp': 'bev_warp_kernel',
    "K7' bev_warp_backward": 'bev_warp_bwd', 'K8 lift_splat_raw': 'lift_splat_raw_kernel',
    "K8' lift_splat_raw_backward": 'lift_splat_raw_bwd'}

# the fake rig's pitch under --raw-rig: every camera 3 degrees about its
# optical x axis, as tests/test_training/test_trainer_e2e.py pitches it
RAW_RIG_PITCH_DEG = 3.0


# a B=4 step on the tree before the fused DCN backward (K5') and K4' on the
# tensor cores, for comparison: device ms and device ops a profiled step,
# peak GiB of the unprofiled steps (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md section 5)
BEFORE = {'lidar_cam_radar': {'device_ms_per_step': 261.25, 'device_ops_per_step': 9362,
                              'max_memory_allocated_gb': 32.98}}


def train_batch(cfg, seed: int, pitch_deg: float = 0.0) -> Dict[str, Any]:
    """The fixed fake batch of a profiled train step; with the camera a
    rotated, flipped and scaled BEV augmentation (``random_bda_matrices``)
    and the rig's cameras pitched by ``pitch_deg``."""
    batch = make_fake_batch(cfg, seed=seed, pitch_deg=pitch_deg)
    if cfg.use_cam:
        batch['bda_mat'] = random_bda_matrices(cfg.batch_size, seed=seed + 1)
    return batch


def depth_loss_ms(cfg, iters: int = 10) -> float:
    """Device time of :func:`depth_loss_fn` forward and backward at ``cfg``'s
    train step shapes: the key frame's bf16 depth [B*N, D, fH, fW] (a
    softmax, channels-last like the DepthNet's) against one-hot labels."""
    bb = cfg.get_backbone_conf()
    gen = torch.Generator(device='cuda').manual_seed(0)
    bn, d, (fh, fw) = cfg.batch_size * cfg.num_cameras, bb.depth_channels, bb.feat_hw
    logits = torch.randn(bn, fh, fw, d, generator=gen, device='cuda').bfloat16()
    depth = logits.permute(0, 3, 1, 2).softmax(1).detach().requires_grad_()
    labels = torch.nn.functional.one_hot(
        torch.randint(0, d, (bn, fh, fw), generator=gen, device='cuda'), d).float()

    def step():
        depth.grad = None
        depth_loss_fn(labels, depth).backward()
    return device_ms(step, iters)


def benchmark_train(train_step: Callable, state: TrainState, batch: Dict[str, Any],
                    steps: int) -> dict:
    """Step time on the host clock (batch in host memory to the updated
    state and metrics on the card, each step ending in a synchronize),
    samples/s at the p50, and the peak device memory over the steps."""
    torch.cuda.reset_peak_memory_stats()
    lat, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics['train_loss']))
    lat = np.asarray(lat)
    b = int(batch['points'].shape[0])
    p50 = float(np.percentile(lat, 50))
    return {'p50_ms': p50, 'p90_ms': float(np.percentile(lat, 90)),
            'samples_per_s': b / p50 * 1e3, 'steps': steps, 'batch_size': b,
            'max_memory_allocated_gb': torch.cuda.max_memory_allocated() / 2**30,
            'losses': losses}


def beside_dense(cfg, state, train_step, batch, steps: int, warmup: int, seed: int,
                 rounds: int = 4) -> dict:
    """The sparse-import step (``cfg``, ``state``, ``train_step``) and the
    dense encoder's on the same batch: step p50 / p90 on the host clock in
    ``rounds`` alternating rounds of ``steps`` steps each (PERF.md section 7:
    two p50s only from one process, in turns), and each step's profiled
    device ms and device ops."""
    import dataclasses
    dense_cfg = cfg.replace(lidar_conf=dataclasses.replace(cfg.get_lidar_conf(),
                                                           variant='dense'))
    dense_step = make_train_step(dense_cfg)
    states = {'sparse': state, 'dense': create_train_state(
        dense_cfg, BEVDepthLiDAR(dense_cfg, generator=torch.Generator().manual_seed(seed)))}
    steps_fn = {'sparse': train_step, 'dense': dense_step}
    for _ in range(warmup):
        states['dense'], _ = dense_step(states['dense'], batch)
    lat = {k: [] for k in states}
    for r in range(rounds):
        for label in (('sparse', 'dense') if r % 2 == 0 else ('dense', 'sparse')):
            for _ in range(steps):
                t0 = time.perf_counter()
                states[label], _ = steps_fn[label](states[label], batch)
                torch.cuda.synchronize()
                lat[label].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for label in states:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                states[label], _ = steps_fn[label](states[label], batch)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == 'CUDA' and e.self_device_time_total > 0]
        out[label] = {'p50_ms': float(np.percentile(lat[label], 50)),
                      'p90_ms': float(np.percentile(lat[label], 90)), 'samples': len(lat[label]),
                      'device_ms_per_step': sum(e.self_device_time_total for e in kernels)
                      / 1e3 / steps,
                      'device_ops_per_step': sum(e.count for e in kernels) / steps}
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--config', default='lidar_radar', choices=('lidar_radar', 'lidar_cam_radar'))
    p.add_argument('--raw-rig', action='store_true',
                   help='the general splat (K8, K8\') on a rig pitched by 3 degrees')
    p.add_argument('--cameras', type=int, default=None,
                   help="the fake rig's camera count (default the config's num_cameras)")
    p.add_argument('--batch-size', type=int, default=4)
    p.add_argument('--steps', type=int, default=10)
    p.add_argument('--warmup', type=int, default=3)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--trace', default=None, help='write a Chrome trace here')
    p.add_argument('--ops-only', action='store_true',
                   help='print only the device ops of one step after the warm-up')
    p.add_argument('--sparse-import', action='store_true',
                   help='the sparse-import LiDAR encoder on LiDAR-like points')
    p.add_argument('--beside-dense', action='store_true',
                   help='with --sparse-import: also the dense encoder\'s step on the same batch, '
                        'the two in alternating rounds')
    p.add_argument('--one-rank-group', action='store_true',
                   help='the step as the one rank of an NCCL process group')
    args = p.parse_args(argv)
    if args.beside_dense and not args.sparse_import:
        raise SystemExit('--beside-dense goes with --sparse-import')
    if not args.one_rank_group:
        return _profile(args)
    with tempfile.TemporaryDirectory() as tmp:
        parallel.initialize(backend='nccl', device='cuda',
                            init_method=f'file://{os.path.join(tmp, "rendezvous")}',
                            world_size=1, rank=0)
        try:
            return _profile(args)
        finally:
            torch.distributed.destroy_process_group()


def _profile(args) -> dict:
    """:func:`main`'s measurements for its parsed ``args``."""
    cfg = getattr(variants, args.config)(
        batch_size=args.batch_size, max_points_per_frame=100_000,
        **({'num_cameras': args.cameras} if args.cameras else {}))
    if args.raw_rig:
        cfg = raw_rig(cfg)
    if args.sparse_import:
        cfg = sparse_import(cfg)
    model = BEVDepthLiDAR(cfg, generator=torch.Generator().manual_seed(args.seed))
    state = create_train_state(cfg, model)
    train_step = make_train_step(cfg)
    batch = train_batch(cfg, args.seed, RAW_RIG_PITCH_DEG if args.raw_rig else 0.0)
    if args.sparse_import:
        batch = with_lidar_like_points(batch, cfg, args.seed)
    for _ in range(args.warmup):
        state, _ = train_step(state, batch)
    torch.cuda.synchronize()
    parallel.reset_counts()
    state, _ = train_step(state, batch)
    collectives = dict(parallel.COUNTS)
    if args.ops_only:
        box = [state]

        def one():
            box[0], _ = train_step(box[0], batch)
            torch.cuda.synchronize()
        result = {'device': torch.cuda.get_device_name(0), 'config': args.config,
                  'raw_rig': args.raw_rig, 'batch_size': args.batch_size,
                  'device_ops_one_step': sum(device_ops(one).values())}
        print(json.dumps(result))
        return result
    timed = benchmark_train(train_step, state, batch, args.steps)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)

    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type.name == 'CUDA' and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    top_dev = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:25]
    own = {label: [sum(e.self_device_time_total for e in kernels if key in e.key) / 1e3
                   / args.steps, sum(e.count for e in kernels if key in e.key) / args.steps]
           for label, key in KERNEL_NAMES.items()}
    host = [e for e in events if e.device_type.name == 'CPU']
    top_host = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    launches = sum(e.count for e in host if e.key.startswith('cudaLaunchKernel')) / args.steps
    result = {
        'device': torch.cuda.get_device_name(0), 'config': args.config,
        'raw_rig': args.raw_rig, 'sparse_import': args.sparse_import,
        'batch_size': args.batch_size, 'cameras': cfg.num_cameras if cfg.use_cam else 0,
        'steps': args.steps, 'unprofiled': timed, 'one_rank_group': args.one_rank_group,
        'collectives_per_step': collectives,
        'wall_ms_per_step': wall_ms, 'device_ms_per_step': device_ms,
        'device_busy_share': device_ms / wall_ms,
        'device_ops_per_step': sum(e.count for e in kernels) / args.steps,
        'kernel_launch_calls_per_step': launches,
        'host_self_ms_per_step': sum(e.self_cpu_time_total for e in host) / 1e3 / args.steps,
        'top_device_ms_per_step': [
            (e.key[:80], e.self_device_time_total / 1e3 / args.steps, e.count / args.steps)
            for e in top_dev],
        'port_kernels_ms_and_launches_per_step': own,
        'top_host_self_ms_per_step': [
            (e.key[:80], e.self_cpu_time_total / 1e3 / args.steps, e.count / args.steps)
            for e in top_host],
    }
    if cfg.use_cam:
        result['depth_loss_forward_backward_ms'] = depth_loss_ms(cfg)
    if args.beside_dense:
        result['alternating_with_dense'] = beside_dense(cfg, state, train_step, batch,
                                                        args.steps, args.warmup, args.seed)
    if (args.batch_size == 4 and args.config in BEFORE and not args.raw_rig
            and cfg.num_cameras == 4):
        result['before'] = BEFORE[args.config]
    print(json.dumps(result, indent=1))
    return result


if __name__ == '__main__':
    main()
