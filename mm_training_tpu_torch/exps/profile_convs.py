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

``--lidar-stem`` instead times the LiDAR encoder's first conv
(``stage0_conv0``: 3x3, 16 out, stride 1, bf16 channels_last) at the B=4
train step's input [4, C, 128, 1024] for C = 20 (the space-to-depth of 5
features) and the zero-padded 24 and 32: its forward, and its forward and
backward as the train step runs it (a weight gradient; the input comes from
kernel K1 and needs none). ``--train`` times every conv module of one B=4
``lidar_radar`` train step alone, forward and backward with the gradients
the step takes (the weight's, and the input's where the input carries one),
on the input the step gave it, slowest first (the encoder's first conv, run
with its padded kernel, is ``--lidar-stem``'s); ``--train --config
lidar_cam_radar`` does so for the camera train step (ResNet-50, the image
neck, the DepthNet with ASPP and the DCN's offset conv, the fuse layer and
the head), where a conv that falls to a cuDNN fallback kernel shows as the
outlier.

    python -m mm_training_tpu_torch.exps.profile_convs [--config lidar_cam_radar]
        [--batch-size 1] [--iters 5] [--top 20]
    python -m mm_training_tpu_torch.exps.profile_convs --lidar-stem [--iters 20]
    python -m mm_training_tpu_torch.exps.profile_convs --train [--config lidar_cam_radar]
        [--iters 5] [--top 20]
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
from ..training import create_train_state, make_predict_step, make_train_step
from .timing import device_ms

__all__ = ['lidar_stem', 'main', 'train_convs']


def lidar_stem(iters: int, channels=(20, 24, 32), batch_size: int = 4) -> list:
    """[{channels, forward_ms, forward_backward_ms}] of the LiDAR encoder's
    first conv at [batch_size, C, 128, 1024] bf16 for each C."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = []
    for c in channels:
        conv = nn.Conv2d(c, 16, 3, 1, 1, bias=False).to(
            'cuda', torch.bfloat16, memory_format=torch.channels_last)
        x = torch.randn(batch_size, c, 128, 1024, generator=gen, device='cuda').bfloat16()
        x = x.contiguous(memory_format=torch.channels_last)
        g = torch.randn(batch_size, 16, 128, 1024, generator=gen, device='cuda').bfloat16()
        g = g.contiguous(memory_format=torch.channels_last)

        def train():
            conv.weight.grad = None
            conv(x).backward(g)
        with torch.inference_mode():
            fwd = device_ms(lambda: conv(x), iters)
        rows.append(dict(channels=c, input=list(x.shape), forward_ms=fwd,
                         forward_backward_ms=device_ms(train, iters)))
    return rows


def train_convs(iters: int, batch_size: int = 4, config: str = 'lidar_radar') -> list:
    """[{module, input, out_channels, conv, input_grad, ms}] of every conv
    module one ``config`` train step at ``batch_size`` runs, each timed
    alone forward and backward on the input and with the weights' dtype the
    step gave it, slowest first."""
    from .profile_train import train_batch
    cfg = getattr(variants, config)(batch_size=batch_size, max_points_per_frame=100_000)
    model = BEVDepthLiDAR(cfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model)
    inputs = {}

    def keep_input(name):
        def hook(mod, inp):
            inputs.setdefault(name, (mod, inp[0].detach(), inp[0].requires_grad))
        return hook
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.register_forward_pre_hook(keep_input(name))
    make_train_step(cfg)(state, train_batch(cfg, 0))
    del state

    rows = []
    for name, (mod, x, input_grad) in inputs.items():
        params = {k: v.detach().to(x.dtype).requires_grad_() for k, v in mod.named_parameters()}
        x = x.clone().requires_grad_(input_grad)
        g = torch.randn_like(torch.func.functional_call(mod, params, (x,)))

        def step():
            for t in (x, *params.values()):
                t.grad = None
            torch.func.functional_call(mod, params, (x,)).backward(g)
        (kh, kw), (sh, _), (dh, _) = mod.kernel_size, mod.stride, mod.dilation
        rows.append(dict(module=name, input=list(x.shape), out_channels=mod.out_channels,
                         conv=f'{type(mod).__name__} {kh}x{kw}/{sh} d{dh}',
                         input_grad=input_grad, ms=device_ms(step, iters)))
    return sorted(rows, key=lambda r: r['ms'], reverse=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--config', default=None,
                   choices=('lidar_only', 'lidar_radar', 'lidar_cam', 'lidar_cam_radar'),
                   help='default lidar_cam_radar; with --train, lidar_radar')
    p.add_argument('--batch-size', type=int, default=1)
    p.add_argument('--iters', type=int, default=5)
    p.add_argument('--top', type=int, default=20)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--lidar-stem', action='store_true',
                   help="time the LiDAR encoder's first conv at 20, 24 and 32 input channels")
    p.add_argument('--train', action='store_true',
                   help='time each conv of a B=4 train step, forward and backward')
    args = p.parse_args(argv)
    if args.lidar_stem:
        result = {'device': torch.cuda.get_device_name(0), 'lidar_stem': lidar_stem(args.iters)}
        print(json.dumps(result))
        return result
    if args.train:
        config = args.config or 'lidar_radar'
        rows = train_convs(args.iters, config=config)
        result = {'device': torch.cuda.get_device_name(0), 'config': config, 'convs': len(rows),
                  'sum_ms': sum(r['ms'] for r in rows), 'top': rows[:args.top]}
        print(json.dumps({k: v for k, v in result.items() if k != 'top'}))
        for r in result['top']:
            print(json.dumps(r))
        return result

    args.config = args.config or 'lidar_cam_radar'
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
