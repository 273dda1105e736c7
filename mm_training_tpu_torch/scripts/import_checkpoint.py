"""Import a reference (torch) checkpoint into the port.

The port's ``mm_training_tpu/scripts/import_checkpoint.py``: a released
aimotive/mm_training checkpoint (a state dict with mmdet/mmdet3d names) is
converted (``models/torch_import.py``), loaded into a freshly built port
model, run once on a fake batch (on the card unless ``--device cpu``), and
optionally written as a port checkpoint (``<out>/0/state.pt``, the
trainer's format) that ``Config.ckpt_path`` / ``Trainer.restore`` load.

By default the LiDAR branch takes the sparse-import encoder
(``LidarEncoderConf.variant='sparse_import'``), so every reference module,
the spconv SparseEncoder included, converts with zero skipped weights;
``--lidar-variant dense`` keeps the dense encoder (its LiDAR branch then
starts from the init).

Usage:
    python -m mm_training_tpu_torch.scripts.import_checkpoint CKPT \\
        --config lidar_cam_radar [--out DIR] [--device cpu] [key=value ...]
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import torch

__all__ = ['import_checkpoint', 'main']


def import_checkpoint(ckpt_path: str, cfg, out: Optional[str] = None, smoke: bool = True,
                      device=None) -> dict:
    """Convert, load, smoke-test and (with ``out``) write; returns the
    coverage report of ``torch_import.convert_reference_checkpoint`` plus
    ``checkpoint``, ``forward_smoke`` and ``saved``."""
    from ..data import make_fake_batch
    from ..models import BEVDepthLiDAR
    from ..models.torch_import import (convert_reference_checkpoint, load_reference_state_dict,
                                       merge_state_dict)
    from ..training.train_step import create_train_state, make_predict_step
    from ..training.trainer import _state_to_dict, _write_checkpoint, initial_loop_state

    sd = load_reference_state_dict(ckpt_path)
    model = BEVDepthLiDAR(cfg, device=device)
    converted, report = convert_reference_checkpoint(sd, model)
    merge_state_dict(model, converted)
    report = dict(checkpoint=ckpt_path, **report)
    if smoke:
        boxes, scores, _, _ = make_predict_step(cfg, model)(
            make_fake_batch(cfg, batch_size=1, seed=0))
        finite = bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all())
        report['forward_smoke'] = 'ok' if finite else 'NON-FINITE OUTPUTS'
    if out:
        state = create_train_state(cfg, model)
        _write_checkpoint(Path(out), 0, _state_to_dict(state, initial_loop_state()), {},
                          keep=1, by_metric=False)
        report['saved'] = str(Path(out).resolve() / '0')
    return report


def main(argv=None) -> dict:
    from ..exps.common import build_config, make_parser
    p = make_parser(__doc__, positional=[('ckpt', 'reference checkpoint (.ckpt / .pth / .pt)')])
    p.add_argument('--out', default=None,
                   help='write a port checkpoint there, loadable through ckpt_path')
    p.add_argument('--no-smoke', action='store_true')
    p.add_argument('--lidar-variant', default='sparse_import', choices=['sparse_import', 'dense'],
                   help='sparse_import converts the SparseEncoder weights exactly; dense '
                        'keeps the dense encoder (its LiDAR branch from the init)')
    # intermixed: the overrides may follow options that follow the checkpoint
    args = p.parse_intermixed_args(argv)
    cfg = build_config(args)
    if cfg.use_lidar:
        prev = cfg.get_lidar_conf().variant
        if prev != args.lidar_variant:
            # a checkpoint of one variant does not restore into a model of the
            # other: say so, so that train and eval configs follow
            print(f'NOTE: lidar encoder variant {prev!r} (from the config) -> '
                  f'{args.lidar_variant!r} for this import; configs that load the result '
                  f'must set LidarEncoderConf.variant={args.lidar_variant!r}')
        cfg = cfg.replace(lidar_conf=dataclasses.replace(cfg.get_lidar_conf(),
                                                         variant=args.lidar_variant))
    report = import_checkpoint(args.ckpt, cfg, out=args.out, smoke=not args.no_smoke,
                               device=args.device)
    print(json.dumps(report, indent=2))
    return report


if __name__ == '__main__':
    main()
