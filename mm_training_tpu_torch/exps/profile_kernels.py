"""Kernel A and its backward A' at every distinct shape the paths launch.

Runs one B=1 predict request, one B=4 predict batch and one B=4 train step
of the full-width ``lidar_radar`` model (bf16, seeded random weights) while
recording each call of :func:`~mm_training_tpu_torch.ops.affine_act.affine_act`
and :func:`~mm_training_tpu_torch.ops.affine_act.affine_act_backward` (shape,
dtype, residual, ReLU), then times each distinct call on random inputs of
that shape: the kernel's device time, the plain version's, and the bound
(the bytes it must move over 3.35 TB/s). Prints one JSON object.

    python -m mm_training_tpu_torch.exps.profile_kernels
"""
from __future__ import annotations

import collections
import json
from typing import Optional, Sequence
from unittest import mock

import torch

from ..configs import lidar_radar
from ..data import make_fake_batch
from ..models import BEVDepthLiDAR
from ..ops import affine_act
from ..training import create_train_state, make_predict_step, make_train_step
from .timing import HBM_BYTES_PER_S, device_ms

__all__ = ['main']


def _recording(calls: collections.Counter, op: str, fn):
    def wrapper(*args):
        x = args[1] if op == 'backward' else args[0]
        residual = args[4] if op == 'backward' else args[3]
        relu = args[5] if op == 'backward' else args[4]
        calls[(op, tuple(x.shape), str(x.dtype).split('.')[-1],
               residual is not None, bool(relu))] += 1
        return fn(*args)
    wrapper.launches = 0   # the wrapped function counts its launches here while patched
    return wrapper


def record(run) -> collections.Counter:
    """Count the calls of kernel A and A' that ``run()`` makes, by shape."""
    calls = collections.Counter()
    with mock.patch.object(affine_act, 'affine_act',
                           _recording(calls, 'forward', affine_act.affine_act)), \
            mock.patch.object(affine_act, 'affine_act_backward',
                              _recording(calls, 'backward', affine_act.affine_act_backward)):
        run()
        torch.cuda.synchronize()
    return calls


def _time(op, shape, dtype, residual, relu, gen) -> dict:
    dt = getattr(torch, dtype)

    def cl():
        return torch.randn(*shape, generator=gen, device='cuda').to(dt).contiguous(
            memory_format=torch.channels_last)
    x, r, g = cl(), (cl() if residual else None), cl()
    s = torch.randn(shape[1], generator=gen, device='cuda')
    t = torch.randn(shape[1], generator=gen, device='cuda')
    if op == 'forward':
        def kernel():
            return affine_act.affine_act(x, s, t, r, relu)

        def plain():
            return affine_act.affine_act_plain(x, s, t, r, relu)
        tensors = 2 + residual                       # x (r) in, out
    else:
        def kernel():
            return affine_act.affine_act_backward(g, x, s, t, r, relu)

        def plain():
            return affine_act.affine_act_backward_plain(g, x, s, t, r, relu)
        tensors = 3 + 2 * residual                   # g, x (r) in, dx (dr) out
    nbytes = tensors * x.numel() * x.element_size()
    ms = device_ms(kernel, 50)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {'ms': ms, 'plain_ms': device_ms(plain, 10), 'bound_ms': bound,
            'bound_share': bound / ms}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    del argv
    gen = torch.Generator().manual_seed(0)
    cfg1 = lidar_radar(batch_size=1, max_points_per_frame=100_000)
    cfg4 = lidar_radar(batch_size=4, max_points_per_frame=100_000)
    model = BEVDepthLiDAR(cfg4, generator=gen)
    predict = make_predict_step(cfg1, model)
    b1, b4 = make_fake_batch(cfg1, seed=0), make_fake_batch(cfg4, seed=0)
    state = create_train_state(cfg4, model)
    train_step = make_train_step(cfg4)
    paths = {'predict B=1': record(lambda: predict(b1)),
             'predict B=4': record(lambda: predict(b4)),
             'train B=4': record(lambda: train_step(state, b4))}
    keys = sorted({k for c in paths.values() for k in c})
    dgen = torch.Generator(device='cuda').manual_seed(0)
    rows = []
    for key in keys:
        op, shape, dtype, residual, relu = key
        row = {'op': op, 'shape': list(shape), 'dtype': dtype, 'residual': residual,
               'relu': relu, 'launches': {p: c[key] for p, c in paths.items() if c[key]}}
        row.update(_time(op, shape, dtype, residual, relu, dgen))
        rows.append(row)
        print(json.dumps(row), flush=True)
    totals = {p: {op: sum(r['ms'] * r['launches'].get(p, 0) for r in rows if r['op'] == op)
                  for op in ('forward', 'backward')}
              for p in paths}
    result = {'device': torch.cuda.get_device_name(0), 'shapes': len(rows),
              'kernel_ms_per_call': totals}
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
