"""The control's precision: the reference computed in float8 (e4m3), the
step below the configuration's bf16. Every product layer (convolution,
transposed convolution, deformable conv) takes its input and its kernel
rounded to e4m3 and hands on its output rounded to e4m3, each after a
per-tensor scale that maps the largest magnitude to e4m3's largest, 448,
as fp8 recipes scale them; sums inside a product stay float32. Gradients
pass the rounding unchanged (straight through)."""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

E4M3_MAX = 448.0


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


def _round_input(module, args):
    return (fake_fp8(args[0]),) + tuple(args[1:])


def _round_output(module, args, out):
    return fake_fp8(out)


def round_products(model: nn.Module):
    """Round the input and the output of every product layer of ``model``;
    returns the hook handles."""
    handles = []
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) or type(m).__name__ == 'DeformConv2d':
            handles.append(m.register_forward_pre_hook(_round_input))
            handles.append(m.register_forward_hook(_round_output))
    return handles


def round_kernels(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The 4-D kernels of ``named`` rounded, the rest as they are."""
    return {n: fake_fp8(t) if t.dim() == 4 else t for n, t in named.items()}
