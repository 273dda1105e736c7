"""Process-group runtime helpers: rank, world size, barrier, object gather.

The port of ``mm_training_tpu/parallel/multihost.py`` (itself the TPU
re-design of the reference's ``utils/torch_dist.py``) on
``torch.distributed``. One process is one rank on one device: NCCL carries
the collectives between cards, gloo between CPU processes (the tests) or,
when the caller names it, between processes that share one card.

``initialize`` forms the group from explicit arguments or from the
environment ``torchrun`` sets (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``). Without a group every helper answers for a
single process: rank 0 of 1, a barrier that returns at once.
"""
from __future__ import annotations

import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from .. import resolve_device

__all__ = ['initialize', 'process_index', 'process_count', 'is_main_process',
           'barrier', 'all_gather_object', 'active']


def active() -> bool:
    """True while a process group is up (of any size): the steps then take
    their batch statistics, loss normalizers and gradients over the group."""
    return dist.is_available() and dist.is_initialized()


def initialize(backend: Optional[str] = None, device=None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``world_size`` and ``rank`` default to the environment's ``WORLD_SIZE``
    and ``RANK``; with neither given nor set this is a single process and
    nothing is formed. ``device`` defaults to the card: under ``torchrun``
    it is ``cuda:LOCAL_RANK``, made current before the group forms;
    ``device='cpu'`` asks for the CPU. ``backend`` defaults to NCCL for a
    CUDA device and gloo for the CPU; gloo on a CUDA device is taken only
    when named (several ranks on one card). ``init_method`` defaults to
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``).

    A group that cannot form raises (a bad address, a rendezvous timeout):
    a rank must never go on as an independent single-process run that
    believes it is rank 0 (JAX :36-46). Calling it again in a process that
    is already in a group of the same size returns its device."""
    if world_size is None and 'WORLD_SIZE' in os.environ:
        world_size = int(os.environ['WORLD_SIZE'])
    if rank is None and 'RANK' in os.environ:
        rank = int(os.environ['RANK'])
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    if world_size is None:
        return dev
    if rank is None:
        raise ValueError(f'a world of {world_size} processes needs this process\'s rank '
                         '(the rank argument or RANK)')
    if active():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f'already in a group of {dist.get_world_size()} processes, '
                               f'not {world_size}')
        return dev
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    dist.init_process_group(backend, init_method=init_method or 'env://',
                            world_size=world_size, rank=rank)
    return dev


def process_index() -> int:
    """Rank of this process (torch_dist.get_rank)."""
    return dist.get_rank() if active() else 0


def process_count() -> int:
    """Number of processes (torch_dist.get_world_size)."""
    return dist.get_world_size() if active() else 1


def is_main_process() -> bool:
    return process_index() == 0


def barrier(group=None) -> None:
    """Every rank of ``group`` (default the world) waits here for the
    others (torch_dist.synchronize)."""
    if active():
        dist.barrier(group)


def all_gather_object(obj: Any, group=None) -> List[Any]:
    """``obj`` of every rank of ``group`` (default the world), in the
    group's rank order (torch_dist.all_gather_object): the trainer pools
    the data ranks' mAP accumulations with it (``parallel.data_group()``:
    model peers hold the same rows). Every rank of the group calls it.
    Pickled; the ranks are this program's own processes."""
    if not active():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
