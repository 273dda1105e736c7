"""Device time of every convolution of the predict path, one by one.

Builds a full-width model (``--config``, default ``lidar_cam_radar``) with
seeded random weights, runs one B-sized predict request with a hook on every
``Conv2d`` / ``ConvTranspose2d`` that keeps its input, then times each conv
alone on that input (``exps/timing.py::device_ms``) and prints them as JSON,
slowest first, with the module name, the input shape and the share of the
summed conv time. Shows which layer shape falls off cuDNN's tensor-core
kernels. ASPP's ``AtrousConv2d`` rows also give both of its forms,
``direct_dilated_ms`` (one dilated cuDNN call) and ``phase_split_ms`` (a
plain 3x3 conv over the phase sub-images, which it runs from dilation 12
on).

    python -m mm_training_tpu_torch.exps.profile_convs [--config lidar_cam_radar]
        [--batch-size 1] [--iters 5] [--top 20]
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch
from torch import nn

from ..configs import variants
from ..data import make_fake_batch
from ..models import BEVDepthLiDAR
from ..models.depth_net import AtrousConv2d, phase_split_conv3x3
from ..training import make_predict_step
from .timing import device_ms

__all__ = ['main']


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--config', default='lidar_cam_radar',
                   choices=('lidar_only', 'lidar_radar', 'lidar_cam', 'lidar_cam_radar'))
    p.add_argument('--batch-size', type=int, default=1)
    p.add_argument('--iters', type=int, default=5)
    p.add_argument('--top', type=int, default=20)
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)

    cfg = getattr(variants, args.config)(batch_size=args.batch_size,
                                         max_points_per_frame=100_000)
    model = BEVDepthLiDAR(cfg, generator=torch.Generator().manual_seed(args.seed))
    inputs = {}

    def keep_input(name):
        def hook(mod, inp):
            inputs.setdefault(name, (mod, inp[0]))
        return hook
    # the predict step's bf16 copy of the model carries these hooks; each
    # keeps the first input its conv sees
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.register_forward_pre_hook(keep_input(name))
    make_predict_step(cfg, model)(make_fake_batch(cfg, seed=args.seed))

    rows = []
    with torch.inference_mode():
        for name, (mod, x) in inputs.items():
            ms = device_ms(lambda: mod(x), args.iters)
            (kh, kw), (sh, _), (dh, _) = mod.kernel_size, mod.stride, mod.dilation
            row = dict(module=name, input=list(x.shape), out_channels=mod.out_channels,
                       conv=f'{kh}x{kw}/{sh} d{dh}', ms=ms)
            if isinstance(mod, AtrousConv2d):   # both forms, whichever the module runs
                row['direct_dilated_ms'] = device_ms(
                    lambda: nn.Conv2d.forward(mod, x), args.iters)
                row['phase_split_ms'] = device_ms(
                    lambda: phase_split_conv3x3(x, mod.weight, dh), args.iters)
            rows.append(row)
    total = sum(r['ms'] for r in rows)
    for r in rows:
        r['share'] = r['ms'] / total
    rows.sort(key=lambda r: r['ms'], reverse=True)
    result = {'device': torch.cuda.get_device_name(0), 'config': args.config,
              'batch_size': args.batch_size, 'dtype': cfg.precision,
              'convs': len(rows), 'sum_ms': total, 'top': rows[:args.top]}
    print(json.dumps({k: v for k, v in result.items() if k != 'top'}))
    for r in result['top']:
        print(json.dumps(r))
    return result


if __name__ == '__main__':
    main()
