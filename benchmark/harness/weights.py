"""The weights of a cell, made by the benchmark from the seed on the device
and handed to the program and to the reference alike.

Every 4-D kernel (convolutions, transposed convolutions, the deformable
conv's kernel and its offset conv) is drawn normal with std 1/sqrt(fan_in)
from one ``torch.randn`` over all of them, in ``named_parameters`` order;
biases are zero except each heatmap branch's last, which is the head's
``init_bias``; BatchNorm is a fresh one (scale 1, shift 0, running mean 0,
running variance 1). A parameter of any other layout raises.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def _layouts(model: nn.Module, init_bias: float):
    """{parameter or buffer name: (kind, fan_in or value)}."""
    out = {}
    for mname, m in model.named_modules():
        prefix = mname + '.' if mname else ''
        for pname, p in m.named_parameters(recurse=False):
            name = prefix + pname
            if p.dim() == 4:
                cin = p.shape[0] if isinstance(m, nn.ConvTranspose2d) else p.shape[1]
                out[name] = ('normal', cin * p.shape[2] * p.shape[3])
            elif p.dim() == 1 and isinstance(m, nn.BatchNorm2d):
                out[name] = ('fill', 1.0 if pname == 'weight' else 0.0)
            elif p.dim() == 1 and pname == 'bias':
                out[name] = ('fill', 0.0)
            else:
                raise ValueError(f'no weight rule for {name} {tuple(p.shape)}')
        if isinstance(m, nn.BatchNorm2d):
            out[prefix + 'running_mean'] = ('fill', 0.0)
            out[prefix + 'running_var'] = ('fill', 1.0)
        if mname.endswith('.heatmap') and isinstance(m, nn.Sequential):
            last = [n for n, _ in m.named_parameters() if n.endswith('bias')][-1]
            out[prefix + last] = ('fill', init_bias)
    return out


@torch.no_grad()
def make(model: nn.Module, seed: int, init_bias: float, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every parameter and
    floating buffer of ``model`` (shapes from the model), drawn from
    ``seed``."""
    layouts = _layouts(model, init_bias)
    shapes = dict((n, t.shape) for n, t in model.named_parameters())
    shapes.update((n, t.shape) for n, t in model.named_buffers() if t.is_floating_point())
    missing = set(shapes) - set(layouts)
    if missing:
        raise ValueError(f'no weight rule for {sorted(missing)[:5]}')
    normal = [n for n, _ in model.named_parameters() if layouts[n][0] == 'normal']
    total = sum(shapes[n].numel() for n in normal)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    draw = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for n in normal:
        k = shapes[n].numel()
        out[n] = draw[at:at + k].view(shapes[n]) * layouts[n][1] ** -0.5
        at += k
    for n, shape in shapes.items():
        if n not in out:
            out[n] = torch.full(shape, layouts[n][1], dtype=torch.float32, device=device)
    return out


@torch.no_grad()
def load(model: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the model's parameters and floating buffers."""
    named = dict(model.named_parameters())
    named.update((n, b) for n, b in model.named_buffers() if b.is_floating_point())
    if set(named) != set(weights):
        raise ValueError('the weights do not name the model\'s tensors')
    for n, t in named.items():
        t.copy_(weights[n])
