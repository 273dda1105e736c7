"""Per-layer quantities of a traced run, read for one loop. A metric's file
``benchmark/metrics/<quantity>.<loop>.py`` binds its ``read`` with
:func:`for_file`, which takes the quantity and the loop from the file's
name; a run of another loop reads nothing.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

from ..roofline.kernels import kernel_of
from ..roofline.peaks import BF16_FLOPS
from .trace import busy_seconds


def device_busy_ms(out) -> float:
    """The union of the slice's device-operation intervals, a step."""
    sl = out['slice']
    return 1e3 * busy_seconds(sl['device']) / sl['steps']


def device_idle_pct(out) -> float:
    """100 x (1 - the slice's busy time a step / the unprofiled window's
    time a step of the same run)."""
    return 100.0 * (1.0 - device_busy_ms(out) * 1e-3 / out['stats']['mean_s'])


def device_ops_per_step(out) -> float:
    """Device operations (kernels, copies, fills) a step in the slice."""
    sl = out['slice']
    return len(sl['device']) / sl['steps']


def mfu_pct(out) -> float:
    """Model FLOPs of a step (``benchmark/roofline/flops.py``) over the
    unprofiled window's time a step, as a share of the bf16 peak."""
    return 100.0 * out['step_flops'] / (out['stats']['mean_s'] * BF16_FLOPS)


def kernel_roofline_pct(out) -> Optional[float]:
    """The sum of each port kernel's least time
    (``benchmark/roofline/kernels.py``) over the sum of its device time in
    the slice, over the kernels it ran that have a count; nothing when it
    ran none."""
    sl, bounds = out['slice'], out['kernel_bounds_s']
    spent: Dict[str, float] = {}
    for name, start, end in sl['device']:
        k = kernel_of(name)
        if k in bounds:
            spent[k] = spent.get(k, 0.0) + (end - start)
    if not spent:
        return None
    return 100.0 * sum(bounds[k] for k in spent) * sl['steps'] / sum(spent.values())


QUANTITIES = {f.__name__: f for f in (device_busy_ms, device_idle_pct, device_ops_per_step,
                                      mfu_pct, kernel_roofline_pct)}


def for_file(path: str) -> Callable[[dict], Optional[float]]:
    """The reader that ``<quantity>.<loop>.py`` names."""
    quantity, loop = Path(path).name[:-len('.py')].rsplit('.', 1)
    read = QUANTITIES[quantity]

    def read_loop(out):
        return read(out) if out['loop'] == loop else None
    return read_loop
