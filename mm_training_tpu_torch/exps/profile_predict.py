"""Where a predict request's time goes on the card (torch.profiler).

Builds a full-width model (``--config lidar_radar``, or ``lidar_only``,
``lidar_cam``, ``lidar_cam_radar``) with seeded random weights, warms the
predict step up, then profiles ``--requests`` B-sized requests and prints:
host wall time per request, device time per request summed over kernels,
the device's busy share (device time / wall time), launches per request,
the share of the host-to-device copies, and the kernels and host ops that
take the most time. With the LiDAR depth oracle (``use_depth_loss``), a
second, shorter profile that records input shapes gives the device time of
the lift's eager use of the fp32 oracle (``models/lss_fpn.py``: the max
over its bins, the comparison, the cast to the compute dtype, the
``where``), its ops found by their shapes.

``--host-gap`` (a camera config) builds the factorized and the raw-rig
model (the same seeded weights) in one process and attributes the
difference of their request times: p50 of each over rounds in the order
factorized, raw, raw, factorized; then one profile of each with the host
self-time of every op and the ops whose host time differs most.

    python -m mm_training_tpu_torch.exps.profile_predict [--config lidar_radar]
        [--batch-size 1] [--requests 20] [--trace predict_trace.json]
        [--host-gap]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import raw_rig, variants
from ..data import make_fake_batch
from ..models import BEVDepthLiDAR
from ..training import make_predict_step
from .profile_train import RAW_RIG_PITCH_DEG

__all__ = ['host_gap', 'main', 'oracle_lift_ms']

ORACLE_OPS = ('aten::amax', 'aten::gt', 'aten::_to_copy', 'aten::where')


def oracle_lift_ms(predict, batch, cfg, requests: int = 5) -> dict:
    """{op: device ms a request} of the lift's eager ops on the depth oracle
    (the permuted [B*N, D, fH, fW] float32 labels and their [B*N, 1, fH,
    fW] foreground mask), from a profile of ``requests`` requests that
    records input shapes; 'total' sums them."""
    bb = cfg.get_backbone_conf()
    m = cfg.batch_size * cfg.num_cameras
    shapes = ([m, bb.depth_channels, *bb.feat_hw], [m, 1, *bb.feat_hw])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(requests):
            [o.cpu() for o in predict(batch)]
    out = {}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in ORACLE_OPS and e.input_shapes and list(e.input_shapes[0]) in shapes:
            out[e.key] = out.get(e.key, 0.0) + e.device_time_total / 1e3 / requests
    out['total'] = sum(out.values())
    return out


def host_gap(cfg, seed: int = 0, requests: int = 20, rounds: int = 2) -> dict:
    """The factorized ``cfg`` against its raw-rig form in one process (see
    the module's docstring): p50 host ms a request of each round, host
    self ms a request of each op under the profiler and the 12 ops whose
    host time differs most."""
    steps = {}
    for name, c, pitch in (('factorized', cfg, 0.0), ('raw_rig', raw_rig(cfg), RAW_RIG_PITCH_DEG)):
        model = BEVDepthLiDAR(c, generator=torch.Generator().manual_seed(seed))
        steps[name] = (make_predict_step(c, model), make_fake_batch(c, seed=seed,
                                                                   pitch_deg=pitch))
        for _ in range(3):
            [o.cpu() for o in steps[name][0](steps[name][1])]
    torch.cuda.synchronize()
    p50 = {name: [] for name in steps}
    for _ in range(rounds):
        for name in ('factorized', 'raw_rig', 'raw_rig', 'factorized'):
            predict, batch = steps[name]
            times = []
            for _ in range(requests):
                t0 = time.perf_counter()
                [o.cpu() for o in predict(batch)]
                times.append((time.perf_counter() - t0) * 1e3)
            p50[name].append(statistics.median(times))
    host = {}
    for name, (predict, batch) in steps.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(requests):
                [o.cpu() for o in predict(batch)]
        host[name] = {e.key: e.self_cpu_time_total / 1e3 / requests
                      for e in prof.key_averages() if e.device_type.name == 'CPU'}
    keys = set(host['factorized']) | set(host['raw_rig'])
    diff = {k: host['raw_rig'].get(k, 0.0) - host['factorized'].get(k, 0.0) for k in keys}
    return {'p50_ms_by_round': p50,
            'p50_ms': {k: statistics.median(v) for k, v in p50.items()},
            'host_self_ms_total': {k: sum(v.values()) for k, v in host.items()},
            'largest_host_differences_ms': sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:12]}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--config', default='lidar_radar',
                   choices=('lidar_only', 'lidar_radar', 'lidar_cam', 'lidar_cam_radar'))
    p.add_argument('--raw-rig', action='store_true',
                   help='the general splat (K8) on a rig pitched by 3 degrees')
    p.add_argument('--batch-size', type=int, default=1)
    p.add_argument('--requests', type=int, default=20)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--trace', default=None, help='write a Chrome trace here')
    p.add_argument('--host-gap', action='store_true',
                   help='the factorized against the raw-rig model in one process')
    args = p.parse_args(argv)

    cfg = getattr(variants, args.config)(batch_size=args.batch_size,
                                         max_points_per_frame=100_000)
    if args.host_gap:
        if not cfg.use_cam:
            raise SystemExit('--host-gap takes a camera config')
        result = {'device': torch.cuda.get_device_name(0), 'config': args.config,
                  'batch_size': args.batch_size,
                  **host_gap(cfg, args.seed, args.requests)}
        print(json.dumps(result, indent=1))
        return result
    if args.raw_rig:
        if not cfg.use_cam:
            raise SystemExit('--raw-rig takes a camera config')
        cfg = raw_rig(cfg)
    model = BEVDepthLiDAR(cfg, generator=torch.Generator().manual_seed(args.seed))
    predict = make_predict_step(cfg, model)
    batch = make_fake_batch(cfg, seed=args.seed,
                            pitch_deg=RAW_RIG_PITCH_DEG if args.raw_rig else 0.0)
    for _ in range(3):
        [o.cpu() for o in predict(batch)]
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            [o.cpu() for o in predict(batch)]
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.requests
    if args.trace:
        prof.export_chrome_trace(args.trace)

    events = prof.key_averages()

    def device_us(e):
        return e.self_device_time_total

    kernels = [e for e in events if e.device_type.name == 'CUDA' and device_us(e) > 0]
    device_ms = sum(device_us(e) for e in kernels) / 1e3 / args.requests
    launches = sum(e.count for e in kernels) / args.requests
    top_dev = sorted(kernels, key=device_us, reverse=True)[:16]
    h2d_ms = sum(device_us(e) for e in kernels
                 if 'HtoD' in e.key) / 1e3 / args.requests
    host = [e for e in events if e.device_type.name == 'CPU']
    top_host = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    result = {
        'device': torch.cuda.get_device_name(0), 'config': args.config,
        'raw_rig': args.raw_rig, 'batch_size': args.batch_size,
        'requests': args.requests, 'wall_ms_per_request': wall_ms,
        'device_ms_per_request': device_ms,
        'device_busy_share': device_ms / wall_ms,
        'device_ops_per_request': launches,
        'h2d_copy_ms_per_request': h2d_ms,
        'h2d_share_of_device_time': h2d_ms / device_ms,
        'top_device_ms_per_request': [
            (e.key[:80], device_us(e) / 1e3 / args.requests, e.count / args.requests)
            for e in top_dev],
        'top_host_self_ms_per_request': [
            (e.key[:80], e.self_cpu_time_total / 1e3 / args.requests,
             e.count / args.requests) for e in top_host],
    }
    if cfg.use_cam and cfg.use_depth_loss:
        result['depth_oracle_lift_ms_per_request'] = oracle_lift_ms(predict, batch, cfg)
    print(json.dumps(result, indent=1))
    return result


if __name__ == '__main__':
    main()
