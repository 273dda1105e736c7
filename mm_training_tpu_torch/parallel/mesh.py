"""A data-parallel rank's share of the global batch.

The port of what a data-parallel rank needs from
``mm_training_tpu/parallel/mesh.py``. There a global batch is one array
sharded over the mesh's data axis; here each rank holds rows ``[lo, hi)``
of it on its own device, the rows its loader reads
(``training/loader.py::PrefetchLoader(process_rows=...)``), and the step
sums over the group what the global-view jit summed over the batch
(``parallel/collectives.py``). The TPU mesh itself (``make_mesh`` with
``model_parallel`` and ``num_slices``, the spatial BEV sharding,
``parallel/dryrun.py``) is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .multihost import process_count, process_index

__all__ = ['process_batch_bounds', 'shard_batch']


def process_batch_bounds(global_batch: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of a global batch of ``global_batch`` that this
    rank holds: equal contiguous shares in rank order."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f'a global batch of {global_batch} does not split over '
                         f'{n} ranks')
    per = global_batch // n
    lo = process_index() * per
    return lo, lo + per


def shard_batch(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """This rank's rows (:func:`process_batch_bounds`) of a global host
    batch, its arrays copied to ``device``; entries that are not arrays pass
    through."""
    sizes = {len(v) for v in batch.values() if isinstance(v, np.ndarray)}
    if len(sizes) != 1:
        raise ValueError(f'the batch\'s arrays disagree on the batch axis: {sorted(sizes)}')
    lo, hi = process_batch_bounds(sizes.pop())
    return {k: torch.as_tensor(np.ascontiguousarray(v[lo:hi]), device=device)
            if isinstance(v, np.ndarray) else v for k, v in batch.items()}
