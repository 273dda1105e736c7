"""Evaluation entry point (the port of ``mm_training_tpu/exps/evaluate.py``):
load a checkpoint, run the test pass (losses + BEV mAP + aiMotive-JSON
export), in one process or under ``torchrun`` as ``exps/train.py`` says
(``model_parallel`` and ``num_slices`` overrides included).

    python -m mm_training_tpu_torch.exps.evaluate --config eval_lidar_radar \\
        --data-root /data/aimotive_dataset ckpt_path=output/lidar_radar/saved_models/best
"""
from __future__ import annotations

import json

from .. import parallel
from ..training.trainer import Trainer
from .common import build_config, parse_args, process_group

__all__ = ['main']


def main(argv=None):
    args = parse_args(argv, description='Evaluate a checkpoint')
    cfg = build_config(args)
    with process_group(args.device) as device:
        trainer = Trainer(cfg, device=device)
        try:
            trainer.setup(steps_per_epoch=1)
            first = next(iter(trainer.loader('val')))
            trainer.init_state(first)  # restores cfg.ckpt_path if set
            metrics = trainer.test(max_batches=args.max_batches)
        finally:
            trainer.close()
        if parallel.is_main_process():
            print(json.dumps({k: float(v) for k, v in metrics.items()}, indent=2))
    return metrics


if __name__ == '__main__':
    main()
