#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mm_training_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one NVIDIA H100

Phases, each raising on failure:
  1. build the three CUDA kernels from ``mm_training_tpu_torch/csrc`` (one
     nvcc per source, in parallel) and print the build time;
  2. hold each kernel against its plain PyTorch version at the serving
     path's shapes, and time kernel, plain version and, where one exists,
     a single PyTorch call computing the same function;
  3. serve the full-width ``lidar_radar`` predict path (grid 256 x 2048,
     8-feature points, bf16, seeded random weights): distinct B=1 requests,
     one B=4 batch and a p50/p90/p99 latency run, with every kernel's launch
     count reset before and read after;
  4. check what came out: finite boxes of the expected shapes, pred maps
     equal to the same model run through the plain versions (bf16
     tolerance), and the fp32 tiny config on the card against the port's
     CPU path (TF32 off; boxes to 1e-3, scores to 1e-4).
The last lines are the kernels JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result. It imports nothing of JAX or of the JAX package.
"""
import copy
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM (data sheet, 700 W)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores


def _ms(fn, iters):
    """Device time of one call: ``iters`` calls queued behind a device-side
    sleep, so they run back to back however slowly the host enqueues them,
    timed with CUDA events. A call whose launches overflow the launch queue
    is timed with the gaps the host leaves."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)      # ~50 ms of device time
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _call_ms(fn, iters):
    """Host time of one call, enqueue to completion (what a caller waits)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _randomize_bn(model, gen):
    """Random BN affine and running statistics, so kernel A applies real
    per-channel scales (a fresh BN is the identity)."""
    from mm_training_tpu_torch.models.bn_fold import BatchNorm2d
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                c = m.num_features
                m.weight.copy_(1 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.2 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.5 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))


def check_kernels(cfg):
    """Phase 2: each kernel against its plain version at the path's shapes."""
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.ops import affine_act, circle_nms, voxelize

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    # --- kernel A at the head's dominant BN shape (B=1: 64 x 512 x 64 ch,
    # the neck deblocks, shared conv and 24 SeparateHead branches), plus the
    # residual and no-ReLU forms at the trunk's BasicBlock shape
    def cl(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x = cl(1, 64, 64, 512)
    s, t = torch.randn(64, generator=gen, device=dev), torch.randn(64, generator=gen, device=dev)
    err = (affine_act.affine_act(x, s, t).float()
           - affine_act.affine_act_plain(x, s, t).float()).abs().max().item()
    xr, rr = cl(1, 320, 4, 32), cl(1, 320, 4, 32)
    sr, tr = torch.randn(320, generator=gen, device=dev), torch.randn(320, generator=gen, device=dev)
    for res, relu in ((rr, True), (None, False), (rr, False)):
        d = (affine_act.affine_act(xr, sr, tr, res, relu).float()
             - affine_act.affine_act_plain(xr, sr, tr, res, relu).float())
        err = max(err, d.abs().max().item())
    nbytes = 2 * x.numel() * x.element_size()
    rows.append(dict(
        name='affine_act', route='cuda', source='mm_training_tpu_torch/csrc/affine_act.cu',
        replaces='scripts/bn_elementwise_probe.py:88', max_abs_err=err,
        ms=_ms(lambda: affine_act.affine_act(x, s, t), 200),
        call_ms=_call_ms(lambda: affine_act.affine_act(x, s, t), 200),
        plain_ms=_ms(lambda: affine_act.affine_act_plain(x, s, t), 50),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by='bytes', library_ms=None,
        shape=list(x.shape), dtype='bfloat16'))

    # --- K1 on a B=1 request of the path (100k points, full grid)
    batch = make_fake_batch(cfg, batch_size=1, seed=SEED)
    pts = torch.as_tensor(batch['points'], device=dev)
    mask = torch.as_tensor(batch['point_mask'], device=dev)
    geo = (cfg.point_cloud_range, cfg.voxel_size, cfg.out_shape)
    nf = cfg.get_lidar_conf().voxelization.num_features
    got = voxelize.voxelize_pillars_dense(pts, mask, *geo, num_features=nf)
    want = voxelize.voxelize_pillars_dense_plain(pts, mask, *geo, num_features=nf)
    seg = voxelize.pillar_segments(pts, mask, *geo)[0]
    feats = pts[0, :, :nf].contiguous()
    index = seg[:, None].expand(-1, nf)
    n_cells = cfg.out_shape[0] * cfg.out_shape[1]

    def library():   # one PyTorch call computing the per-pillar mean
        return torch.zeros(n_cells + 1, nf, device=dev).scatter_reduce_(
            0, index, feats, 'mean', include_self=False)
    lib_err = (library()[:n_cells].view_as(want[0]) - want[0]).abs().max().item()
    # the mask, the nf averaged features of each masked-in point, the grid out
    nbytes = mask.numel() + int(mask.sum()) * nf * 4 + got.numel() * 4
    rows.append(dict(
        name='voxelize_pillars_dense', route='cuda',
        source='mm_training_tpu_torch/csrc/voxelize.cu',
        replaces='mm_training_tpu/ops/voxelize.py:27',
        max_abs_err=(got - want).abs().max().item(),
        ms=_ms(lambda: voxelize.voxelize_pillars_dense(pts, mask, *geo, num_features=nf), 100),
        call_ms=_call_ms(lambda: voxelize.voxelize_pillars_dense(pts, mask, *geo,
                                                                 num_features=nf), 100),
        plain_ms=_ms(lambda: voxelize.voxelize_pillars_dense_plain(pts, mask, *geo, num_features=nf), 20),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by='bytes',
        library_ms=_ms(library, 20), library_max_abs_err=lib_err,
        shape=list(pts.shape), dtype='float32'))

    # --- K3 on one request's (batch, task) rows: 4 x K=500 candidates
    head = cfg.get_head_conf()
    r, k = len(head.tasks), head.bbox_coder.max_num
    pc = cfg.point_cloud_range
    lo = torch.tensor(pc[:2], device=dev)
    hi = torch.tensor(pc[3:5], device=dev)
    centers = lo + torch.rand(r, k, 2, generator=gen, device=dev) * (hi - lo)
    scores = torch.rand(r, k, generator=gen, device=dev)
    valid = torch.rand(r, k, generator=gen, device=dev) < 0.9
    thresh = torch.tensor(head.test_cfg.min_radius[:r], dtype=torch.float32, device=dev)
    keep = circle_nms.circle_nms_mask(centers, scores, valid, thresh)
    keep_plain = circle_nms.circle_nms_mask_plain(centers, scores, valid, thresh)
    nbytes = r * k * (8 + 4 + 1 + 1) + r * 4
    n_valid = valid.sum(1).long()
    # 2 sub, 2 mul, 1 add for each pair of valid boxes (invalid ones never
    # suppress and are never kept)
    flops = int((n_valid * (n_valid - 1) // 2).sum()) * 5
    rows.append(dict(
        name='circle_nms_mask', route='cuda', source='mm_training_tpu_torch/csrc/circle_nms.cu',
        replaces='mm_training_tpu/ops/circle_nms.py:23',
        max_abs_err=(keep.int() - keep_plain.int()).abs().max().item(),
        ms=_ms(lambda: circle_nms.circle_nms_mask(centers, scores, valid, thresh), 100),
        call_ms=_call_ms(lambda: circle_nms.circle_nms_mask(centers, scores, valid, thresh), 100),
        plain_ms=_ms(lambda: circle_nms.circle_nms_mask_plain(centers, scores, valid, thresh), 3),
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
        bound_by='operations' if flops / FP32_FLOPS > nbytes / HBM_BYTES_PER_S else 'bytes',
        library_ms=None, kept=int(keep.sum()), shape=[r, k], dtype='float32'))

    for row in rows:
        print(f"kernel {row['name']}: max_abs_err={row['max_abs_err']} ms={row['ms']:.6f} "
              f"call_ms={row['call_ms']:.6f} plain_ms={row['plain_ms']:.6f} "
              f"bound_ms={row['bound_ms']:.6f} library_ms={row['library_ms']}", flush=True)
    if rows[0]['max_abs_err'] != 0:       # same fp32 steps, one rounding
        raise AssertionError(f'affine_act differs from its plain version: {rows[0]}')
    if not rows[1]['max_abs_err'] <= 1e-4:  # atomics: fp32 sums in another order
        raise AssertionError(f'voxelize differs from its plain version: {rows[1]}')
    if rows[2]['max_abs_err'] != 0:
        raise AssertionError(f'circle_nms differs from its plain version: {rows[2]}')
    return rows


def serve(cfg):
    """Phase 3: the full-width predict path through its entry points."""
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.exps.inference import benchmark_latency
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.ops import affine_act, circle_nms, voxelize
    from mm_training_tpu_torch.training import make_predict_step

    gen = torch.Generator().manual_seed(SEED)
    model = BEVDepthLiDAR(cfg, device='cuda', generator=gen)
    _randomize_bn(model, gen)
    predict = make_predict_step(cfg, model)
    requests = [make_fake_batch(cfg, batch_size=1, seed=SEED + i) for i in range(6)]
    big = make_fake_batch(cfg, batch_size=4, seed=SEED + 100)
    wrappers = {'affine_act': affine_act.affine_act,
                'voxelize_pillars_dense': voxelize.voxelize_pillars_dense,
                'circle_nms_mask': circle_nms.circle_nms_mask}

    for w in wrappers.values():
        w.launches = 0
    outs, lat = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append([o.cpu() for o in predict(req)])
        lat.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    out_big = [o.cpu() for o in predict(big)]
    lat_big = (time.perf_counter() - t0) * 1e3
    stats = benchmark_latency(predict, requests[0], iters=200)
    stats_b4 = benchmark_latency(predict, big, iters=40)
    counts = {n: w.launches for n, w in wrappers.items()}
    calls = len(requests) + 1 + (stats['samples'] + 1) + (stats_b4['samples'] + 1)

    print(f'serve: {len(requests)} B=1 requests {[round(v, 3) for v in lat]} ms '
          f'(first includes warm-up), B=4 batch {lat_big:.3f} ms', flush=True)
    print('serve latency B=1: ' + json.dumps(stats), flush=True)
    print('serve latency B=4: ' + json.dumps(stats_b4), flush=True)
    print(f'serve: launches over {calls} predict calls {json.dumps(counts)}', flush=True)
    missing = [n for n, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f'kernels never launched on the main path: {missing}')

    n_out = len(cfg.get_head_conf().tasks) * cfg.get_head_conf().test_cfg.post_max_size
    for o, b in [(o, 1) for o in outs] + [(out_big, 4)]:
        boxes, scores, labels, valid = o
        if boxes.shape != (b, n_out, 9) or scores.shape != (b, n_out):
            raise AssertionError(f'unexpected output shapes {boxes.shape} {scores.shape}')
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
            raise AssertionError('non-finite boxes or scores')
        if not valid.any(1).all():
            raise AssertionError('a request decoded no box')
    return model, requests[0], counts, calls


def compare_plain(model, request):
    """Phase 4a: pred maps through the kernels vs the plain versions (bf16);
    the forward runs A and K1 (K3 is decode's, held in phase 2)."""
    from mm_training_tpu_torch.ops import affine_act, voxelize
    from mm_training_tpu_torch.training import cast_floating

    net = cast_floating(model, torch.bfloat16)
    pts = torch.as_tensor(request['points'], device='cuda')
    mask = torch.as_tensor(request['point_mask'], device='cuda')
    with torch.inference_mode():
        got = net(pts, mask)
        before = (affine_act.affine_act.launches, voxelize.voxelize_pillars_dense.launches)
        with mock.patch.object(affine_act, 'affine_act', affine_act.affine_act_plain), \
                mock.patch.object(voxelize, 'voxelize_pillars_dense',
                                  voxelize.voxelize_pillars_dense_plain):
            want = net(pts, mask)
        if (affine_act.affine_act.launches, voxelize.voxelize_pillars_dense.launches) != before:
            raise AssertionError('the plain run launched a kernel')
    worst = 0.0
    for g, w in zip(got, want):
        for name in w:
            gf, wf = g[name].float(), w[name].float()
            # kernel A matches bit for bit; K1's atomics move a voxel mean by
            # fp32 ulps, which can flip a bf16 rounding of the encoder input
            # and travel through ~40 bf16 layers: allow 1/32 of the map's scale
            rel = ((gf - wf).abs().max() / wf.abs().max().clamp_min(1.0)).item()
            worst = max(worst, rel)
    print(f'plain-path pred maps (bf16): worst max|diff| / max|map| = {worst:.6g}', flush=True)
    if not worst <= 1 / 32:
        raise AssertionError(f'kernel and plain pred maps differ: {worst}')
    return worst


def compare_cpu_reference():
    """Phase 4b: the fp32 tiny config on the card vs the port's CPU path."""
    from mm_training_tpu_torch.configs import tiny_test_config
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.training import make_predict_step

    torch.backends.cudnn.allow_tf32 = False        # fp32 comparison: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_test_config(use_cam=False)
    gen = torch.Generator().manual_seed(SEED + 1)
    cpu_model = BEVDepthLiDAR(cfg, device='cpu', generator=gen)
    _randomize_bn(cpu_model, gen)
    gpu_model = copy.deepcopy(cpu_model).to('cuda')
    batch = make_fake_batch(cfg, seed=SEED + 2)
    gb, gs, gl, gv = (o.cpu().numpy() for o in make_predict_step(cfg, gpu_model)(batch))
    wb, ws, wl, wv = (o.numpy() for o in make_predict_step(cfg, cpu_model)(batch))
    if not (np.array_equal(gv, wv) and np.array_equal(gl[wv], wl[wv])
            and np.abs(gs - ws).max() <= 1e-4):
        raise AssertionError('tiny fp32 predict on the card differs from the CPU path')
    worst = 0.0
    for b, i in zip(*np.nonzero(wv)):   # near-tied scores may trade slots
        same = gv[b] & (gl[b] == wl[b, i]) & (np.abs(gs[b] - ws[b, i]) <= 1e-4)
        worst = max(worst, float(np.abs(gb[b, same] - wb[b, i]).max(-1).min()))
    print(f'tiny fp32 card vs CPU: {int(wv.sum())} kept boxes, worst box err {worst:.3g}',
          flush=True)
    if not worst <= 1e-3:
        raise AssertionError(f'tiny fp32 boxes differ from the CPU path by {worst}')


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from mm_training_tpu_torch.configs import lidar_radar
    from mm_training_tpu_torch.ops import build

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f'torch {torch.__version__} cuda {torch.version.cuda} on {card}', flush=True)
    t0 = time.perf_counter()
    build.build_kernels()
    print(f'build: {time.perf_counter() - t0:.3f} s for {len(build.KERNEL_SOURCES)} '
          'kernels (parallel nvcc)', flush=True)

    cfg = lidar_radar(batch_size=1, max_points_per_frame=100_000)
    rows = check_kernels(cfg)
    model, request, counts, calls = serve(cfg)
    compare_plain(model, request)
    compare_cpu_reference()

    for row in rows:
        row['launches'] = counts[row['name']]
        row['launches_per_request'] = counts[row['name']] / calls
    print(json.dumps({'kernels': rows}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
