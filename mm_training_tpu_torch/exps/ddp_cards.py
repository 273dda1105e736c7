"""Data parallelism over several cards: NCCL ranks, one a card.

    python -m mm_training_tpu_torch.exps.ddp_cards [--world 4]

On a machine with ``--world`` cards (and the kernels' toolchain):

1. full-width ``lidar_radar`` in float32 (TF32 off): one train step of
   ``--world`` ranks at B=2 each against one process at B=2 x world on the
   same frames from the same weights, beside the one process against itself
   (``exps/step_checks.py``); the ranks' parameters the same bits;
2. full-width ``lidar_cam_radar`` in bf16 at B=4 a rank: the step p50 of
   the ranks (2 warm-up and 6 timed steps, at the same time on their cards)
   beside one process at B=4 without a group on card 0;
3. ``exps.train`` under ``torchrun --nproc_per_node world`` (``lidar_radar``,
   float32, ``batch_size=1``, 2 steps, a val pass, the test pass) against
   one process at ``batch_size=world`` on one tree of LAZ frames: the test
   losses and the pooled predictions.

Each line it prints is a JSON object; the last is ``{"ok": ...}``, and it
exits non-zero when a check fails.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .step_checks import step_comparison, within_step_tolerances

__all__ = ['main', 'rank_child']

SEED = 44


def _lidar_case(batch_size, device):
    from ..configs import lidar_radar
    from ..models import BEVDepthLiDAR
    from .profile_train import train_batch
    cfg = lidar_radar(batch_size=batch_size, max_points_per_frame=100_000, precision='fp32')
    model = BEVDepthLiDAR(cfg, device=device, generator=torch.Generator().manual_seed(SEED))
    return cfg, model, train_batch(cfg, SEED + 1)


def _camera_p50(device, steps=8, warmup=2):
    """(p50 ms, each timed step's ms) of the bf16 ``lidar_cam_radar`` step at
    B=4 on ``device``, each step ending in a host read of its loss."""
    from ..configs import lidar_cam_radar
    from ..models import BEVDepthLiDAR
    from ..training import create_train_state, make_train_step
    from .profile_train import train_batch
    cfg = lidar_cam_radar(batch_size=4, max_points_per_frame=100_000)
    model = BEVDepthLiDAR(cfg, device=device, generator=torch.Generator().manual_seed(SEED + 2))
    state, step, batch = create_train_state(cfg, model), make_train_step(cfg), train_batch(
        cfg, SEED + 3)
    lat = []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m['train_loss'])
        if i >= warmup:
            lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(lat, 50)), lat


def rank_child(rank, world, rendezvous, result_file):
    """Checks 1 and 2 as rank ``rank`` of an NCCL group on ``cuda:rank``;
    writes the step's metrics, parameters, BN statistics and all-reduces,
    and the camera step's times, to ``result_file``."""
    from .. import parallel
    from ..training import create_train_state, make_train_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = parallel.initialize(backend='nccl', device=f'cuda:{rank}',
                                 init_method=f'file://{rendezvous}', world_size=world,
                                 rank=rank)
    try:
        cfg, model, batch = _lidar_case(2 * world, device)
        cfg = cfg.replace(batch_size=2)
        parallel.reset_counts()
        _, m = make_train_step(cfg)(create_train_state(cfg, model),
                                    parallel.shard_batch(batch, device))
        torch.cuda.synchronize()
        result = {'metrics': {k: float(v) for k, v in m.items()},
                  'params': {n: p.detach().cpu() for n, p in model.named_parameters()},
                  'buffers': {n: b.cpu() for n, b in model.named_buffers()},
                  'collectives': dict(parallel.COUNTS)}
        del model
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        result['camera_p50_ms'], result['camera_ms'] = _camera_p50(device)
        torch.save(result, result_file)
    finally:
        torch.distributed.destroy_process_group()


def _run(argv, timeout):
    """stdout of ``argv`` run in a session of its own, killed whole if it
    outlives ``timeout``; raises on a non-zero exit."""
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode:
        raise RuntimeError(f'{argv[:6]} exited with {proc.returncode}')
    return stdout


def _train(world, tree, out):
    """The test metrics ``exps.train`` prints (rank 0) on ``world``
    processes, and its wall seconds."""
    launch = ([sys.executable, '-m', 'torch.distributed.run', '--standalone',
               f'--nproc_per_node={world}'] if world > 1 else [sys.executable])
    t0 = time.perf_counter()
    lines = _run(launch + ['-m', 'mm_training_tpu_torch.exps.train', '--config', 'lidar_radar',
                           '--data-root', tree, '--max-steps', '2',
                           f'batch_size={1 if world > 1 else 4}', 'num_workers=8',
                           'num_sanity_val_steps=0', 'latest_every_n_steps=0',
                           "precision='fp32'", f'out_path={out!r}', f'seed={SEED}'],
                 600).splitlines()
    start = max(i for i, line in enumerate(lines) if line == '{')
    return json.loads('\n'.join(lines[start:lines.index('}', start) + 1])), \
        time.perf_counter() - t0


def main(argv=None) -> int:
    from ..data import generate_synthetic_dataset
    from ..ops import build
    from ..training import create_train_state, make_train_step
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument('--world', type=int, default=4)
    world = args.parse_args(argv).world
    if torch.cuda.device_count() < world:
        raise RuntimeError(f'{world} ranks need {world} cards, found '
                           f'{torch.cuda.device_count()}')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()
    print(json.dumps({'cards': card}), flush=True)
    build.build_kernels()
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        files = [os.path.join(tmp, f'rank{r}.pt') for r in range(world)]
        procs = [subprocess.Popen([sys.executable, '-c', (
            'from mm_training_tpu_torch.exps import ddp_cards; '
            f'ddp_cards.rank_child({r}, {world}, {os.path.join(tmp, "rendezvous")!r}, '
            f'{files[r]!r})')]) for r in range(world)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise RuntimeError(f'the ranks exited with {codes}')
        ranks = [torch.load(f, weights_only=True) for f in files]

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg, model, batch = _lidar_case(2 * world, 'cuda:0')
        old = {n: p.detach().cpu() for n, p in model.named_parameters()}
        models = [model, copy.deepcopy(model)]
        plain = [make_train_step(cfg)(create_train_state(cfg, m), batch) for m in models]
        got = copy.deepcopy(model)
        with torch.no_grad():
            for n, p in got.named_parameters():
                p.copy_(ranks[0]['params'][n])
            for n, b in got.named_buffers():
                b.copy_(ranks[0]['buffers'][n])
        step = {'ranks_vs_one': step_comparison(got, ranks[0]['metrics'], model, *plain[0], old),
                'plain_run_to_run': step_comparison(models[1], plain[1][1], model, *plain[0],
                                                    old),
                'ranks_same_bits': all(torch.equal(r['params'][n], ranks[0]['params'][n])
                                       for r in ranks for n in old),
                'collectives_a_rank': ranks[0]['collectives']}
        ok &= step['ranks_same_bits'] and within_step_tolerances(step['ranks_vs_one'])
        print(json.dumps({f'lidar_radar fp32 step, {world} ranks at B=2 vs one process at '
                          f'B={2 * world}': step}), flush=True)
        del model, models, plain, got
        torch.cuda.empty_cache()

        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        one_p50, one_ms = _camera_p50('cuda:0')
        rank_p50 = [r['camera_p50_ms'] for r in ranks]
        print(json.dumps({f'lidar_cam_radar bf16 step at B=4 a rank, {world} ranks': {
            'p50_ms': rank_p50, 'samples_per_s': 4 * world / max(rank_p50) * 1e3,
            'one_process_p50_ms': one_p50, 'one_process_samples_per_s': 4 / one_p50 * 1e3,
            'ms': [r['camera_ms'] for r in ranks], 'one_process_ms': one_ms}}), flush=True)
        torch.cuda.empty_cache()

        tree = os.path.join(tmp, 'tree')
        for i, (split, n) in enumerate((('train', 16), ('val', 8))):
            generate_synthetic_dataset(tree, splits=(split,), frames_per_sequence=n,
                                       n_objects=12, seed=SEED + i, write_images=False,
                                       n_ground_points=100_000, lidar_format='laz')
        many, many_s = _train(world, tree, os.path.join(tmp, 'many'))
        one, one_s = _train(1, tree, os.path.join(tmp, 'one'))
        rel = {k: abs(many[k] - one[k]) / max(abs(one[k]), 1e-30) for k in one}
        ok &= (rel['test_detection_loss'] <= 2e-4
               and many['test_num_preds'] == one['test_num_preds'])
        print(json.dumps({f'exps.train, torchrun {world} ranks vs one process': {
            'ranks': many, 'one': one, 'rel': rel, 'wall_s': [many_s, one_s]}}), flush=True)
    print(json.dumps({'ok': bool(ok)}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
