"""Shared CLI plumbing for the exps entry points.

The port's copy of ``mm_training_tpu/exps/common.py``, which replaces the
reference's argparse-over-Lightning-Trainer surface
(exps/mm_training_aim.py:610-631): a named config variant plus key=value
overrides, with the same reproducibility knobs (--seed; the config snapshot
is written by the Trainer). The port adds ``--device`` (default: the card).

Under ``torchrun`` (``WORLD_SIZE`` in the environment) an entry point runs
as one rank of a process group (:func:`process_group`): NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``; the trainer lays the ranks
out by the ``model_parallel`` and ``num_slices`` overrides, ``batch_size``
counts a data rank's samples and only rank 0 prints the result.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import os
from typing import Iterator, Optional, Sequence, Tuple

import torch

from .. import parallel
from ..configs import Config, variants

__all__ = ['build_config', 'make_parser', 'parse_args', 'process_group']


@contextlib.contextmanager
def process_group(device=None) -> Iterator[torch.device]:
    """This process's device: under ``torchrun`` it joins the process group
    first (``parallel.initialize``; a group that cannot form raises) and
    leaves it on exit; otherwise ``device`` as given (the card unless
    'cpu')."""
    if 'WORLD_SIZE' not in os.environ:
        yield device
        return
    dev = parallel.initialize(device=device)
    try:
        yield dev
    finally:
        parallel.reset_mesh()
        torch.distributed.destroy_process_group()


def parse_args(argv: Optional[Sequence[str]] = None,
               description: str = '',
               extra_flags: Sequence[str] = ()) -> argparse.Namespace:
    return make_parser(description, extra_flags).parse_args(argv)


def make_parser(description: str = '', extra_flags: Sequence[str] = (),
                positional: Sequence[Tuple[str, str]] = ()) -> argparse.ArgumentParser:
    """The shared parser; ``extra_flags`` are entry-specific boolean
    switches (``--profile`` of exps.train, ``--latency`` and ``--fold-bn``
    of exps.inference); ``positional`` (name, help) arguments come before
    the overrides (the checkpoint of scripts.import_checkpoint)."""
    p = argparse.ArgumentParser(description=description)
    for flag in extra_flags:  # entry-specific boolean switches
        p.add_argument(f'--{flag}', action='store_true')
    p.add_argument('--config', default='lidar_radar',
                   help='config variant name (mm_training_tpu_torch.configs.variants)'
                        ' — lidar_only, lidar_radar, lidar_cam, lidar_cam_radar,'
                        ' eval_lidar_only, eval_lidar_radar, tiny_test_config')
    p.add_argument('--seed', type=int, default=None,
                   help='override the config seed (pl.seed_everything parity)')
    p.add_argument('--data-root', default=None, help='dataset root directory')
    p.add_argument('--max-epochs', type=int, default=None)
    p.add_argument('--max-steps', type=int, default=None)
    p.add_argument('--max-batches', type=int, default=None,
                   help='cap eval/predict batches (smoke runs)')
    p.add_argument('--device', default=None,
                   help='torch device (default cuda; cpu runs the plain versions)')
    for name, text in positional:
        p.add_argument(name, help=text)
    p.add_argument('overrides', nargs='*',
                   help='config overrides as key=value (value parsed as a'
                        ' python literal when possible)')
    return p


def _parse_value(v: str):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def build_config(args: argparse.Namespace) -> Config:
    factory = getattr(variants, args.config, None)
    if factory is None:
        raise SystemExit(f'unknown config variant: {args.config!r}')
    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {}
    for ov in args.overrides:
        if '=' not in ov:
            raise SystemExit(f'override must be key=value, got {ov!r}')
        k, v = ov.split('=', 1)
        if k not in fields:
            raise SystemExit(f'unknown config field {k!r} (the port\'s Config has no such '
                             'field, or it arrives with a later slice)')
        kw[k] = _parse_value(v)
    if args.seed is not None:
        kw['seed'] = args.seed
    if args.data_root is not None:
        kw['data_root'] = args.data_root
    if args.max_epochs is not None:
        kw['max_epochs'] = args.max_epochs
    try:
        return factory(**kw)
    except ValueError as e:    # a value the Config refuses (model_parallel=0, ...)
        raise SystemExit(str(e)) from None
