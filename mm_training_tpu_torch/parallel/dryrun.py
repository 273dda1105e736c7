"""One train step over a world of ranks, for equality checks.

The port of ``mm_training_tpu/parallel/dryrun.py``. The equality contract is
the reference's DDP contract (bev_depth_head.py:274, 300): training over
``world`` ranks laid out as ``model_parallel`` x data-parallel on a global
batch must equal one process training on the SAME global batch, up to float
reassociation. For that the effective learning rate must match too:
``cfg.learning_rate`` scales with a data rank's batch (base/64 *
batch_size), so the optimizer scales it by the data-parallel size
(``create_train_state``'s default), not by the world: model peers share
their rows, and a world scale would train at ``model_parallel`` x the rate.

:func:`spawn_ranks` starts the world: one child process a rank, on the
device the caller names (``'cpu'``: a gloo group; ``'cuda:{rank}'`` or
``'cuda:0'``: NCCL or gloo on cards), each laid out by ``make_mesh`` and
running a function of the caller's choosing on its rows. :func:`run_one_train_step` is one train step
through it; the tests, ``chip_smoke.py`` and ``exps/ddp_cards.py`` use them.
Every run of a step starts from the same weights: the seeded init of the
config, or a given state dict.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ['dryrun_config', 'max_param_diff', 'run_one_train_step', 'spawn_ranks',
           'train_step_rank']

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def dryrun_config(batch_size: int = 1, model_parallel: int = 1, use_cam: bool = True,
                  use_lidar: bool = True, use_radar: bool = True, **kw):
    """The JAX package's slim full-structure geometry (its copy, JAX
    :30-95): every op count and shape is the minimum that still runs the
    whole train step (camera lift-splat + DCN + the LiDAR pillar encoder +
    fusion + the CenterPoint head + the optimizer) over a world of ranks:
    ResNet-10, one DepthNet block, one conv a LiDAR stage, 2 tasks, 1-conv
    heads, a 128 x 128 grid (both extents multiples of 128 cells: the head's
    trunk runs a /4 stem and two stride-2 stages below the /8 input)."""
    from ..configs import (BackboneConf, BEVNeckConf, Config, DepthNetConf,
                           ImageBackboneConf, ImageNeckConf, LidarEncoderConf, TaskConf,
                           VoxelizationConf)
    pc = (-12.8, -12.8, -5.0, 12.8, 12.8, 3.0)
    base = dict(
        experiment_name='dryrun', batch_size=batch_size, model_parallel=model_parallel,
        H=32, W=64, precision='fp32', point_cloud_range=pc,
        use_cam=use_cam, use_lidar=use_lidar, use_radar=use_radar, use_depth_loss=use_cam,
        max_points_per_frame=512, max_objs=8, num_cameras=1,
        backbone_conf=BackboneConf(
            x_bound=(pc[0], pc[3], 0.8), y_bound=(pc[1], pc[4], 0.8),
            z_bound=(pc[2], pc[5], 8.0), d_bound=(2.0, 14.8, 0.8),
            final_dim=(32, 64), output_channels=16, downsample_factor=16,
            img_backbone_conf=ImageBackboneConf(depth=10),
            img_neck_conf=ImageNeckConf(in_channels=(64, 128, 256, 512),
                                        out_channels=(16, 16, 16, 16)),
            depth_net_conf=DepthNetConf(in_channels=64, mid_channels=16, num_blocks=1)),
        lidar_conf=LidarEncoderConf(
            encoder_channels=((8,), (16,), (32,)), out_channels=32,
            voxelization=VoxelizationConf(max_num_points=4, max_voxels=256)),
    )
    base.update(kw)
    cfg = Config(**base)
    head = cfg.get_head_conf()
    head = dataclasses.replace(
        head,
        tasks=(TaskConf(1, ('car',)), TaskConf(1, ('pedestrian',))),
        bev_backbone_conf=dataclasses.replace(head.bev_backbone_conf, base_channels=16),
        bev_neck_conf=BEVNeckConf(in_channels=(16, 32, 64),
                                  upsample_strides=head.bev_neck_conf.upsample_strides,
                                  out_channels=(16, 16, 16)),
        common_heads=(('reg', (2, 1)), ('height', (1, 1)), ('dim', (3, 1)), ('rot', (2, 1)),
                      ('vel', (2, 1))),
        in_channels=48)
    return cfg.replace(head_conf=head)


def _resolve(target: str) -> Callable:
    module, _, name = target.partition(':')
    return getattr(importlib.import_module(module), name)


def _child(rank: int, spec_file: str, out_file: str) -> None:
    """A rank of :func:`spawn_ranks`: join the group, lay it out, run the
    target, pickle its result. JAX, flax and the JAX package are barred from
    its interpreter."""
    for banned in ('jax', 'jaxlib', 'flax', 'mm_training_tpu'):
        sys.modules[banned] = None          # any import of them raises ImportError
    from . import initialize, make_mesh, reset_mesh
    with open(spec_file, 'rb') as f:
        spec = pickle.load(f)
    if spec['device'] == 'cpu':
        torch.set_num_threads(1)
    initialize(backend=spec['backend'], device=spec['device'].format(rank=rank),
               init_method=f'file://{spec["rendezvous"]}', world_size=spec['world'], rank=rank)
    try:
        make_mesh(spec['model_parallel'])
        result = _resolve(spec['target'])(*spec['args'])
        with open(out_file, 'wb') as f:
            pickle.dump(result, f)
    finally:
        reset_mesh()
        torch.distributed.destroy_process_group()


def spawn_ranks(world: int, target: str, args: Sequence[Any] = (), *, device: str,
                model_parallel: int = 1, backend: Optional[str] = None,
                timeout: float = 600.0, env: Optional[Dict[str, str]] = None) -> List[Any]:
    """``target(*args)`` (``'module:function'``, importable from the
    repository's root) on each of ``world`` ranks, each a child process in
    one process group laid out by ``make_mesh(model_parallel)``: the
    results in rank order. ``device`` is formatted with the rank
    (``'cpu'``; ``'cuda:{rank}'``: a card a rank; ``'cuda:0'``: one card
    shared, which takes ``backend='gloo'``); ``backend`` defaults as
    ``parallel.initialize`` does. Raises with every rank's output tail when
    a rank fails or outlives ``timeout`` (the others are killed)."""
    with tempfile.TemporaryDirectory() as tmp:
        spec_file = os.path.join(tmp, 'spec.pkl')
        with open(spec_file, 'wb') as f:
            pickle.dump({'world': world, 'target': target, 'args': tuple(args),
                         'model_parallel': model_parallel, 'device': device, 'backend': backend,
                         'rendezvous': os.path.join(tmp, 'rendezvous')}, f)
        outs = [os.path.join(tmp, f'rank{r}.pkl') for r in range(world)]
        child_env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [_ROOT] + [p for p in os.environ.get('PYTHONPATH', '').split(os.pathsep) if p]))
        if device == 'cpu':
            child_env['OMP_NUM_THREADS'] = '1'
        child_env.update(env or {})
        procs = [subprocess.Popen(
            [sys.executable, '-c', 'import sys; from mm_training_tpu_torch.parallel import '
             'dryrun; dryrun._child(int(sys.argv[1]), sys.argv[2], sys.argv[3])',
             str(r), spec_file, outs[r]], env=child_env, cwd=_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
        logs = [''] * world
        try:
            for r, p in enumerate(procs):
                logs[r] = p.communicate(timeout=timeout)[0].decode(errors='replace')
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise RuntimeError('\n'.join(f'--- rank {r} (rc {p.returncode}) ---\n{logs[r][-3000:]}'
                                         for r, p in enumerate(procs)))
        results = []
        for out in outs:
            with open(out, 'rb') as f:
                results.append(pickle.load(f))
        return results


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def train_step_rank(spec: Dict[str, Any]) -> Dict[str, Any]:
    """One train step of this rank on its rows of ``spec['batch']`` (the
    global batch, numpy): the config ``spec['factory'](batch_size=<a data
    rank's rows>, model_parallel=..., **spec['modalities'])`` with
    ``spec['overrides']`` replaced, the model from ``spec['state']`` (a
    state dict) or the config's seeded init, in ``spec['dtype']`` (default
    float32), a camera
    step's ``spec['draws']`` (the global batch's flips [B*S*N] and keep masks
    [B*N, fH, fW, mid] a sweep, or None: the step's own generator) sliced to
    its rows. Returns its metrics, then Adam's first moments, the
    parameters and the buffers after the step (numpy, by name), and the
    collectives it made."""
    from .. import parallel
    from ..models import BEVDepthLiDAR
    from ..training import create_train_state, make_train_step
    dp = parallel.data_parallel_size()
    global_batch = len(spec['batch']['gt_boxes'])
    cfg = _resolve(spec['factory'])(batch_size=global_batch // dp,
                                    model_parallel=parallel.current_mesh().model_parallel,
                                    **spec['modalities'])
    cfg = cfg.replace(**spec.get('overrides', {}))
    device = 'cpu' if spec['device'] == 'cpu' else 'cuda'   # the rank's card
    if device == 'cuda' and spec.get('tf32') is not None:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = spec['tf32']
    model = BEVDepthLiDAR(cfg, device=device,
                          generator=torch.Generator().manual_seed(spec.get('seed', 0)))
    if spec.get('state') is not None:
        model.load_state_dict(spec['state'])
    model.to(spec.get('dtype', torch.float32))
    state = create_train_state(cfg, model, steps_per_epoch=10)
    lo, hi = parallel.process_batch_bounds(global_batch)
    draws = None
    if spec.get('draws') is not None:
        sn, n = cfg.num_sweeps * cfg.num_cameras, cfg.num_cameras
        draws = {'flipped': torch.as_tensor(spec['draws']['flipped'][lo * sn:hi * sn],
                                            device=device),
                 'dropout': [torch.as_tensor(k[lo * n:hi * n], device=device).permute(0, 3, 1, 2)
                             for k in spec['draws']['dropout']]}
    parallel.reset_counts()
    state, m = make_train_step(cfg)(state, parallel.shard_batch(spec['batch'], device), draws)
    names = [n for n, _ in model.named_parameters()]
    return {'metrics': {k: float(v) for k, v in m.items()},
            'collectives': dict(parallel.COUNTS), 'lr': state.optimizer.schedule(0),
            'mu': {n: _np(mu) for n, mu in zip(names, state.optimizer.mu)},
            'params': {n: _np(p) for n, p in model.named_parameters()},
            'buffers': {n: _np(b) for n, b in model.named_buffers()}}


def run_one_train_step(world: int, model_parallel: int, global_batch: int, *, device: str,
                       modalities: Optional[Dict[str, bool]] = None,
                       batch_np: Optional[Dict[str, np.ndarray]] = None,
                       cfg_factory: str = 'mm_training_tpu_torch.configs:tiny_test_config',
                       state: Optional[Dict[str, torch.Tensor]] = None,
                       draws: Optional[Dict[str, Any]] = None, backend: Optional[str] = None,
                       all_ranks: bool = False, seed: int = 0,
                       tf32: Optional[bool] = None, **overrides):
    """One full train step (targets, forward, losses, gradients, the
    clipped AdamW update) over ``world`` ranks laid out as
    ``model_parallel`` x data-parallel on ``device`` (:func:`spawn_ranks`),
    on the global batch ``batch_np`` (default ``make_fake_batch`` of the
    config at ``global_batch``, seed 0), in float32. ``world`` 1 is one process without a group,
    in this one. Returns (parameters {name: numpy}, metrics {name: float})
    of rank 0, or with ``all_ranks`` each rank's :func:`train_step_rank`
    result. ``cfg_factory`` is ``'module:function'`` (the JAX harness's
    ``dryrun_config`` here is ``'mm_training_tpu_torch.parallel.dryrun:
    dryrun_config'``); ``overrides`` replace config fields; the model is the
    config's init from ``seed`` unless ``state`` is given; ``tf32`` sets
    TF32 on a card's ranks (None: as they start)."""
    from ..data import make_fake_batch
    modalities = modalities or dict(use_cam=True, use_lidar=True, use_radar=True)
    if batch_np is None:
        cfg = _resolve(cfg_factory)(batch_size=global_batch, **modalities)
        batch_np = make_fake_batch(cfg.replace(**overrides), batch_size=global_batch, seed=0)
    spec = {'factory': cfg_factory, 'modalities': modalities, 'batch': batch_np,
            'state': state, 'draws': draws, 'overrides': overrides,
            'device': device, 'seed': seed, 'tf32': tf32}
    if world == 1:
        results = [train_step_rank(spec)]
    else:
        results = spawn_ranks(world, 'mm_training_tpu_torch.parallel.dryrun:train_step_rank',
                              (spec,), device=device, model_parallel=model_parallel,
                              backend=backend)
    if all_ranks:
        return results
    return results[0]['params'], results[0]['metrics']


def max_param_diff(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> float:
    """Largest absolute difference of two parameter dicts of the same
    names."""
    return max(float(np.abs(a[n] - b[n]).max()) for n in a)
