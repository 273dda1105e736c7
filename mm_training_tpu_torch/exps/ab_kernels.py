"""Kernel A' and K4 of this package against another copy of it, in one process.

The other copy (for example an earlier commit unpacked with ``git archive``
into a git-ignored directory) is imported under another module name and
builds its own ``csrc`` into its own ``_build/``. Each case is timed with
:func:`~mm_training_tpu_torch.exps.timing.device_ms` in the order other,
this, this, other, on the same inputs:

- A' at every distinct shape one B=4 ``lidar_radar`` train step launches
  (recorded as ``exps/profile_kernels.py`` records them), at [4,64,64,512]
  bf16 with and without a residual, and at ResNet-50's [4,2048,22,40] bf16
  (a copy that refuses it gets ``null``);
- K4 at the B=1 and the B=4 ``lidar_cam_radar`` request's splat indices,
  bf16, in every layout of ``exps/kernel_inputs.py``: the strided views the
  camera path hands over (depth channels-last, a slice read in place or
  NCHW; ctx a permuted channels-last slice) and contiguous copies.

Prints one JSON object with the card's name and power limit.

    python -m mm_training_tpu_torch.exps.ab_kernels --other path/to/mm_training_tpu_torch
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

import torch

from ..configs import lidar_cam_radar, lidar_radar
from ..data import make_fake_batch
from ..models import BEVDepthLiDAR
from ..ops import affine_act, voxel_pooling
from ..training import create_train_state, make_train_step
from .kernel_inputs import SPLAT_LAYOUTS, splat_inputs
from .profile_kernels import HBM_BYTES_PER_S, record
from .timing import device_ms

__all__ = ['main']


def load_copy(path: str, name: str = 'mm_training_tpu_torch_other'):
    """(ops.affine_act, ops.voxel_pooling) of the package copy at ``path``."""
    path = Path(path).resolve()
    spec = importlib.util.spec_from_file_location(name, path / '__init__.py',
                                                  submodule_search_locations=[str(path)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return (importlib.import_module(f'{name}.ops.affine_act'),
            importlib.import_module(f'{name}.ops.voxel_pooling'))


def _alternate(other, this, iters: int) -> dict:
    """Device ms of other, this, this, other; ``None`` for a side that raises."""
    def timed(fn):
        try:
            return device_ms(fn, iters)
        except (ValueError, RuntimeError) as e:
            print(f'  refused: {e}', flush=True)
            return None
    o1, t1, t2, o2 = timed(other), timed(this), timed(this), timed(other)
    return {'other_ms': [o1, o2], 'this_ms': [t1, t2]}


def backward_shapes() -> list:
    """(shape, residual, relu, launches) of every A' call of one B=4
    ``lidar_radar`` train step, bf16."""
    cfg = lidar_radar(batch_size=4, max_points_per_frame=100_000)
    model = BEVDepthLiDAR(cfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    batch = make_fake_batch(cfg, seed=0)
    step(state, batch)
    calls = record(lambda: step(state, batch))
    return sorted((list(k[1]), k[3], k[4], n) for k, n in calls.items() if k[0] == 'backward')


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--other', required=True, help='directory of the other package copy')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('ab_kernels: needs a CUDA device')
    other_aa, other_vp = load_copy(args.other)
    gen = torch.Generator(device='cuda').manual_seed(0)
    result = {'device': torch.cuda.get_device_name(0),
              'card': subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                                      '--format=csv,noheader'], capture_output=True,
                                     text=True).stdout.strip(),
              'backward': [], 'lift_splat': []}

    cases = [(shape, res, relu, {'train B=4': n}) for shape, res, relu, n in backward_shapes()]
    cases += [([4, 64, 64, 512], False, True, {}), ([4, 64, 64, 512], True, True, {}),
              ([4, 2048, 22, 40], True, True, {})]
    for shape, res, relu, launches in cases:
        def cl():
            return torch.randn(*shape, generator=gen, device='cuda').bfloat16().contiguous(
                memory_format=torch.channels_last)
        x, g, r = cl(), cl(), (cl() if res else None)
        s = torch.randn(shape[1], generator=gen, device='cuda')
        t = torch.randn(shape[1], generator=gen, device='cuda')
        row = {'shape': shape, 'residual': res, 'relu': relu, 'launches': launches,
               'bound_ms': (3 + 2 * res) * x.numel() * 2 / HBM_BYTES_PER_S * 1e3}
        row.update(_alternate(lambda: other_aa.affine_act_backward(g, x, s, t, r, relu),
                              lambda: affine_act.affine_act_backward(g, x, s, t, r, relu), 50))
        result['backward'].append(row)
        print(json.dumps(row), flush=True)

    for batch_size in (1, 4):
        for layout in SPLAT_LAYOUTS:
            a = splat_inputs(lidar_cam_radar(batch_size=batch_size), gen, layout)
            depth, ctx, idx, zvalid, n_cells = a
            nbytes = (depth.numel() * 2 + zvalid.numel() + ctx.numel() * 2 + idx.numel() * 4
                      + idx.shape[0] * n_cells * ctx.shape[-1] * 2)
            row = {'batch_size': batch_size, 'layout': layout,
                   'cameras': idx.shape[0], 'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3}
            row.update(_alternate(lambda: other_vp.lift_splat_factorized(*a),
                                  lambda: voxel_pooling.lift_splat_factorized(*a), 50))
            result['lift_splat'].append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
