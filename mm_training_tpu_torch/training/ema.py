"""Exponential moving average of the model state.

The port of ``mm_training_tpu/training/ema.py`` (:17-26), the functional
re-design of the reference's callbacks/ema.py (ModelEMA/EMACallback): the
decay ramps as ``decay * (1 - exp(-t / 2000))`` (ema.py:36-63) and, like the
reference, which averages the whole state_dict, the parameters and the
BatchNorm statistics are both averaged. The reference defines EMA but never
registers it; here, as in the JAX package, it is a trainer option
(``Config.use_ema``).

The shadow is a dict keyed as ``state_dict()``; the update runs in place
with stock foreach ops over its tensors (the JAX package computes it with
plain XLA ops, no kernel of its own).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ['ema_decay_at', 'ema_update']


def ema_decay_at(updates: int, decay: float = 0.9999) -> float:
    """``decay * (1 - exp(-updates / 2000))`` in float32, as the JAX update
    computes it; ``updates`` is the post-increment update counter. The exp
    is rounded to float32 from float64; XLA's float32 exp gives the same
    value at all but ~0.14% of the steps, where the two differ by one ulp."""
    f32 = np.float32
    e = f32(math.exp(float(-f32(updates) / f32(2000.0))))
    return float(f32(decay) * (f32(1.0) - e))


@torch.no_grad()
def ema_update(shadow: Dict[str, torch.Tensor], new: Mapping[str, torch.Tensor],
               updates: int, decay: float = 0.9999) -> Dict[str, torch.Tensor]:
    """One EMA step of ``shadow`` towards ``new`` (same keys), in place:
    ``e * d + (1 - d) * p`` for each floating entry, in that order and in
    the shadow's dtype (``p`` cast to it); a non-floating entry is copied.
    Returns ``shadow``."""
    d = ema_decay_at(updates, decay)
    keep = float(np.float32(1.0) - np.float32(d))
    es, ps = [], []
    for k, e in shadow.items():
        if e.is_floating_point():
            es.append(e)
            ps.append(new[k].to(e.dtype))
        else:
            e.copy_(new[k])
    if es:
        torch._foreach_mul_(es, d)
        torch._foreach_add_(es, torch._foreach_mul(ps, keep))
    return shadow
