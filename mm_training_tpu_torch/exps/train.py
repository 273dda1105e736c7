"""Training entry point (the port of ``mm_training_tpu/exps/train.py``).

fit (with val each epoch, early stopping, best/latest checkpoints), then a
final test pass with the best checkpoint's weights — the reference's
``trainer.fit(...); trainer.test(ckpt='best')`` (mm_training_aim.py:633-643).

    python -m mm_training_tpu_torch.exps.train --config lidar_radar \\
        --data-root /data/aimotive_dataset [--device cpu] [key=value ...]

Under ``torchrun`` each process is one rank of a process group
(``exps/common.py::process_group``), data-parallel by default, with
``model_parallel=2`` two ranks a W-sharded head (``num_slices=2``: the data
axis node-major over two nodes):

    torchrun --nproc_per_node 2 -m mm_training_tpu_torch.exps.train \\
        --config tiny_test_config --device cpu --data-root ROOT [key=value ...]
    torchrun --nproc_per_node 2 -m mm_training_tpu_torch.exps.train \\
        --config tiny_test_config --device cpu --data-root ROOT model_parallel=2

``--profile`` instead traces ``--max-steps`` (default 5) train steps with
``torch.profiler`` into ``<out_path>/profile/trace.json`` and exits.
"""
from __future__ import annotations

import json

from .. import parallel
from ..training.trainer import Trainer
from .common import build_config, parse_args, process_group

__all__ = ['main']


def main(argv=None):
    args = parse_args(argv, description='Train a BEV detector', extra_flags=('profile',))
    cfg = build_config(args)
    with process_group(args.device) as device:
        trainer = Trainer(cfg, device=device)
        try:
            trainer.setup()
            if args.profile:
                # a device trace of a few train steps, then exit (view in
                # Perfetto or chrome://tracing)
                path = trainer.profile(n_steps=args.max_steps or 5)
                print(f'device trace written under {path}')
                return {}
            trainer.fit(max_epochs=args.max_epochs, max_steps=args.max_steps)
            # reload best checkpoint and run the test pass (mm_training_aim.py:639)
            best = trainer.out_path / 'saved_models' / 'best'
            if best.is_dir():
                trainer.restore(str(best))
            metrics = trainer.test(max_batches=args.max_batches)
        finally:
            trainer.close()
        if parallel.is_main_process():
            print(json.dumps({k: float(v) for k, v in metrics.items()}, indent=2))
    return metrics


if __name__ == '__main__':
    main()
