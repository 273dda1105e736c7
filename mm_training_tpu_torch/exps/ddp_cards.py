"""Data and model parallelism over several cards: NCCL ranks, one a card.

    python -m mm_training_tpu_torch.exps.ddp_cards [--world 4]
    python -m mm_training_tpu_torch.exps.ddp_cards --world 4 --model-parallel 2

On a machine with ``--world`` cards (and the kernels' toolchain), the ranks
started by ``parallel/dryrun.py`` (``spawn_ranks``, ``run_one_train_step``)
and laid out as ``--model-parallel`` M x ``world / M`` (M 1 by default: the
data axis alone):

1. full-width ``lidar_radar`` in float32 (TF32 off): one train step of the
   ranks against one process on the same frames from the same weights,
   beside the one process against itself (``exps/step_checks.py``); the
   ranks' parameters the same bits. The global batch is 2 x world with the
   data axis alone (B=2 a rank), else 4;
2. full-width ``lidar_cam_radar`` in bf16: the step p50 (2 warm-up and 6
   timed steps, the ranks at the same time on their cards) and the peak
   memory a card, beside one card at B=4. With the data axis alone at B=4
   a rank (a global batch of 4 x world); else at a global B=4 in the
   (M, world / M) layout and in the data axis alone (1, world);

with the data axis alone,

3. ``exps.train`` under ``torchrun --nproc_per_node world`` (``lidar_radar``,
   float32, ``batch_size=1``, 2 steps, a val pass, the test pass) against
   one process at ``batch_size=world`` on one tree of LAZ frames: the test
   losses and the pooled predictions;

and with M > 1,

3. the nuScenes config (``lidar_cam`` on a raw rig with six cameras and
   BEVDepth's six tasks, bf16) at a global B=4: the peak memory a card of
   the two layouts and of one card.

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

__all__ = ['layout_rank', 'main']

SEED = 44


def _nuscenes_config(**kw):
    from ..configs import lidar_cam, nuscenes_tasks, raw_rig
    return nuscenes_tasks(raw_rig(lidar_cam(**dict(dict(num_cameras=6), **kw))))


def _memory_and_p50(config, global_batch, steps, warmup, timed):
    """(peak GiB, the step's peak above what is held before it, p50 ms or
    None, each timed step's ms) of the bf16 train step of ``config``
    (``'lidar_cam_radar'`` or ``'nuscenes'``) on this rank's rows of a
    global batch (one card: all of it), each step ending in a host read of
    its loss."""
    from .. import parallel
    from ..configs import lidar_cam_radar
    from ..models import BEVDepthLiDAR
    from ..training import create_train_state, make_train_step
    from .profile_train import RAW_RIG_PITCH_DEG, train_batch
    dp = parallel.data_parallel_size()
    kw = dict(batch_size=global_batch, max_points_per_frame=100_000,
              model_parallel=parallel.current_mesh().model_parallel)
    cfg = lidar_cam_radar(**kw) if config == 'lidar_cam_radar' else _nuscenes_config(**kw)
    batch = train_batch(cfg, SEED + 3, pitch_deg=0.0 if config == 'lidar_cam_radar'
                        else RAW_RIG_PITCH_DEG)
    cfg = cfg.replace(batch_size=global_batch // dp)
    model = BEVDepthLiDAR(cfg, device='cuda', generator=torch.Generator().manual_seed(SEED + 2))
    state, step = create_train_state(cfg, model), make_train_step(cfg)
    rows = parallel.shard_batch(batch, 'cuda')
    lat = []
    for i in range(steps):
        if i == warmup:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state, m = step(state, rows)
        float(m['train_loss'])
        if i >= warmup:
            lat.append((time.perf_counter() - t0) * 1e3)
    above = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    out = (torch.cuda.max_memory_allocated() / 2 ** 30, above,
           float(np.percentile(lat, 50)) if timed else None, lat if timed else [])
    del state, model
    torch.cuda.empty_cache()
    return out


def layout_rank(global_batch, configs):
    """Check 2 (and with the model axis 3) on this rank, or on one card
    without a group (module docstring): ``{config: _memory_and_p50(...)}``."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    return {c: (_memory_and_p50(c, global_batch, 8, 2, True) if c == 'lidar_cam_radar'
                else _memory_and_p50(c, global_batch, 2, 1, False)) for c in configs}


def _step_check(world, m, global_batch):
    """Check 1 (module docstring); True when it passes."""
    from ..configs import lidar_radar
    from ..models import BEVDepthLiDAR
    from ..parallel import dryrun
    from ..training import create_train_state, make_train_step
    from .profile_train import train_batch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = lidar_radar(batch_size=global_batch, max_points_per_frame=100_000, precision='fp32')
    model = BEVDepthLiDAR(cfg, device='cuda:0', generator=torch.Generator().manual_seed(SEED))
    batch = train_batch(cfg, SEED + 1)
    ranks = dryrun.run_one_train_step(
        world, m, global_batch, device='cuda:{rank}', backend='nccl',
        modalities=dict(use_cam=False, use_lidar=True, use_radar=True), batch_np=batch,
        cfg_factory='mm_training_tpu_torch.configs:lidar_radar', all_ranks=True, seed=SEED,
        tf32=False, max_points_per_frame=100_000, precision='fp32')
    old = {n: p.detach().cpu() for n, p in model.named_parameters()}
    models = [model, copy.deepcopy(model)]
    plain = [make_train_step(cfg)(create_train_state(cfg, mm), batch) for mm in models]
    got = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in got.named_parameters():
            p.copy_(torch.from_numpy(ranks[0]['params'][n]))
        for n, b in got.named_buffers():
            b.copy_(torch.from_numpy(ranks[0]['buffers'][n]))
    step = {'ranks_vs_one': step_comparison(got, ranks[0]['metrics'], model, *plain[0], old),
            'plain_run_to_run': step_comparison(models[1], plain[1][1], model, *plain[0], old),
            'ranks_same_bits': all(np.array_equal(r[k][n], ranks[0][k][n]) for r in ranks
                                   for k in ('params', 'buffers') for n in r[k]),
            'collectives_a_rank': ranks[0]['collectives']}
    print(json.dumps({f'lidar_radar fp32 step, {world} ranks at model_parallel={m} vs one '
                      f'process, global B={global_batch}': step}), flush=True)
    del model, models, plain, got
    torch.cuda.empty_cache()
    return step['ranks_same_bits'] and within_step_tolerances(step['ranks_vs_one'])


def _layouts(world, m):
    """Check 2 (and with the model axis 3): each layout's ranks, then one
    card without a group."""
    from ..parallel.dryrun import spawn_ranks
    if m > 1:
        configs, runs = ('lidar_cam_radar', 'nuscenes'), ((m, 4), (1, 4))
    else:
        configs, runs = ('lidar_cam_radar',), ((1, 4 * world),)
    layouts = {f'({mp}, {world // mp}) at global B={gb}': spawn_ranks(
        world, 'mm_training_tpu_torch.exps.ddp_cards:layout_rank', (gb, configs),
        device='cuda:{rank}', model_parallel=mp, backend='nccl', timeout=900)
        for mp, gb in runs}
    one = layout_rank(4, configs)
    for config in configs:
        print(json.dumps({f'{config} bf16 step, (model, data) layouts on {world} cards beside '
                          'one card at B=4': {
                              **{k: {'peak_gib': [r[config][0] for r in rs],
                                     'step_above_held_gib': [r[config][1] for r in rs],
                                     'p50_ms': [r[config][2] for r in rs],
                                     'ms': [r[config][3] for r in rs]}
                                 for k, rs in layouts.items()},
                              'one card': {'peak_gib': one[config][0],
                                           'step_above_held_gib': one[config][1],
                                           'p50_ms': one[config][2], 'ms': one[config][3]}}}),
              flush=True)


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
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument('--world', type=int, default=4)
    args.add_argument('--model-parallel', type=int, default=1)
    parsed = args.parse_args(argv)
    world = parsed.world
    if torch.cuda.device_count() < world:
        raise RuntimeError(f'{world} ranks need {world} cards, found '
                           f'{torch.cuda.device_count()}')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()
    print(json.dumps({'cards': card}), flush=True)
    build.build_kernels()
    ok = _step_check(world, parsed.model_parallel,
                     4 if parsed.model_parallel > 1 else 2 * world)
    _layouts(world, parsed.model_parallel)
    if parsed.model_parallel > 1:
        print(json.dumps({'ok': bool(ok)}))
        return 0 if ok else 1
    with tempfile.TemporaryDirectory() as tmp:
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
