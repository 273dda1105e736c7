"""The (model, data) layout of the ranks and a data rank's share of the batch.

The port of ``mm_training_tpu/parallel/mesh.py``. There ``make_mesh`` lays
the devices out as a (model, data) mesh and the global-view jit shards the
batch over the data axis and the head's BEV along W over the model axis.
Here one process is one rank: :func:`mesh_layout` gives the same
arithmetic on ranks (the model axis outermost; with ``num_slices > 1``
each slice, a node, contributes a ``model_parallel x local-dp`` block and
the data axis is slice-major), and :func:`make_mesh` builds the process
subgroups of the two axes. Ranks of one data index (the **model group**)
hold the same batch rows and different W shards of the head
(``parallel/spatial.py``); ranks of one model index (a **data group**) hold
different rows. Each data rank holds rows ``[lo, hi)`` of the global batch
by its data index, the rows its loader reads
(``training/loader.py::PrefetchLoader(process_rows=...)``), and the step
sums over the world what the global-view jit summed over the batch
(``parallel/collectives.py``).

Without :func:`make_mesh` the layout is the data axis alone: every rank is
a data rank, as in a data-parallel run.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .multihost import process_count, process_index

__all__ = ['Axis', 'Mesh', 'check_layout', 'current_mesh', 'data_group', 'data_index', 'data_parallel_size',
           'make_mesh', 'mesh_layout', 'model_axis', 'model_index', 'once',
           'process_batch_bounds', 'reset_mesh', 'shard_batch']


def mesh_layout(world: int, model_parallel: int = 1, num_slices: int = 1,
                nodes: Optional[Sequence[int]] = None) -> np.ndarray:
    """[model_parallel, world // model_parallel] ranks: JAX's ``make_mesh``
    (:28-78) on devices in rank order whose ``slice_index`` is
    ``nodes[rank]`` (None: no slice information, as on the CPU). With
    ``num_slices > 1`` and as many distinct nodes, the ranks are grouped by
    node (by rank within one); otherwise contiguous groups of
    ``world / num_slices`` ranks act as slices, with a warning when the
    nodes are known but do not number ``num_slices``."""
    m, s = model_parallel, num_slices
    for knob, v in (('model_parallel', m), ('num_slices', s)):
        if v < 1:
            raise ValueError(f'{knob}={v}: the rank layout takes a count of at least 1')
    if world % (m * s):
        raise ValueError(f'a world of {world} ranks does not split into model_parallel={m} '
                         f'x num_slices={s} blocks')
    if s == 1:
        return np.arange(world).reshape(m, world // m)
    order = list(range(world))
    if nodes is not None:
        if len(set(nodes)) == s:
            order = sorted(order, key=lambda r: (nodes[r], r))
        else:
            # contiguous groups may straddle nodes (JAX :58-67)
            warnings.warn(f'num_slices={s} but the ranks run on {len(set(nodes))} nodes; '
                          'falling back to contiguous virtual slices whose collectives may '
                          'cross nodes — set num_slices to the node count')
    per = world // s
    return np.concatenate([np.asarray(order[i * per:(i + 1) * per]).reshape(m, per // m)
                           for i in range(s)], axis=1)


@dataclass(frozen=True)
class Axis:
    """This rank's place on the model axis: its ``index`` of ``size`` in
    ``group``, the subgroup of the ranks holding the same batch rows."""
    group: Any
    index: int
    size: int


@dataclass(frozen=True)
class Mesh:
    """The layout of a world of ranks and this rank's place in it."""
    layout: np.ndarray            # [model_parallel, data_parallel] ranks
    rank: int
    model_group: Any = None       # None when model_parallel == 1
    data_group: Any = None        # None: the whole world (model_parallel == 1)

    @property
    def model_parallel(self) -> int:
        return self.layout.shape[0]

    @property
    def data_parallel(self) -> int:
        return self.layout.shape[1]

    @property
    def world(self) -> int:
        return self.layout.size

    @property
    def position(self) -> Tuple[int, int]:
        """(model index, data index) of this rank."""
        i, j = np.argwhere(self.layout == self.rank)[0]
        return int(i), int(j)


_CURRENT: Optional[Mesh] = None


def _nodes(world: int) -> Optional[list]:
    """Node of each rank under ``torchrun`` (``rank // LOCAL_WORLD_SIZE``),
    else None."""
    local = os.environ.get('LOCAL_WORLD_SIZE')
    return None if local is None else [r // int(local) for r in range(world)]


def make_mesh(model_parallel: int = 1, num_slices: int = 1) -> Mesh:
    """Lay out the process group's ranks (:func:`mesh_layout`, a slice
    being a node) and make it this process's mesh. Every rank calls it with
    the same knobs: it creates the model and data subgroups, collectively.
    Without a group, the one process's mesh (any knob above 1 raises)."""
    global _CURRENT
    world, rank = process_count(), process_index()
    layout = mesh_layout(world, model_parallel, num_slices, _nodes(world))
    model_group = data_group = None
    if model_parallel > 1 and dist.is_initialized():
        for j in range(layout.shape[1]):
            g = dist.new_group([int(r) for r in layout[:, j]])
            if rank in layout[:, j]:
                model_group = g
        for i in range(layout.shape[0]):
            g = dist.new_group([int(r) for r in layout[i]])
            if rank in layout[i]:
                data_group = g
    _CURRENT = Mesh(layout, rank, model_group, data_group)
    return _CURRENT


def reset_mesh() -> None:
    """Forget the mesh (its groups go with the process group)."""
    global _CURRENT
    _CURRENT = None


def current_mesh() -> Mesh:
    """The mesh :func:`make_mesh` made for this process group, else the
    data axis alone over the group."""
    world, rank = process_count(), process_index()
    if _CURRENT is not None and _CURRENT.world == world and _CURRENT.rank == rank:
        return _CURRENT
    return Mesh(np.arange(world)[None], rank)


def check_layout(model_parallel: int) -> None:
    """Raise unless the current mesh has ``model_parallel`` ranks on its
    model axis. The steps read the layout from the mesh, not from a config:
    a step built for another layout would shard, sum and scale the learning
    rate wrongly."""
    have = current_mesh().model_parallel
    if model_parallel != have:
        raise ValueError(f'model_parallel={model_parallel} but the ranks are laid out with '
                         f'model_parallel={have}: call parallel.make_mesh({model_parallel}) '
                         'on every rank first (the trainer does)')


def model_axis() -> Optional[Axis]:
    """This rank's model axis, or None when ``model_parallel`` is 1."""
    mesh = current_mesh()
    if mesh.model_parallel == 1:
        return None
    return Axis(mesh.model_group, mesh.position[0], mesh.model_parallel)


def model_index() -> int:
    return current_mesh().position[0]


def data_index() -> int:
    return current_mesh().position[1]


def data_parallel_size() -> int:
    """Ranks on the data axis: the global batch is this many ranks' rows
    (JAX ``trainer.py:121-123``)."""
    return current_mesh().data_parallel


def data_group():
    """The subgroup of this rank's data axis (None: the whole world)."""
    return current_mesh().data_group


def once(t: torch.Tensor) -> torch.Tensor:
    """``t`` on model index 0 and zeros on its model peers: a quantity every
    model peer holds alike (from the replicated encoders, or of the batch
    rows), counted once in a sum over the world."""
    return t if model_index() == 0 else torch.zeros_like(t)


def process_batch_bounds(global_batch: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of a global batch of ``global_batch`` that this
    rank holds: equal contiguous shares in data-index order (model peers
    hold the same rows)."""
    n = data_parallel_size()
    if global_batch % n:
        raise ValueError(f'a global batch of {global_batch} does not split over '
                         f'{n} data ranks')
    per = global_batch // n
    lo = data_index() * per
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
