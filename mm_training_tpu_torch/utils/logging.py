"""Metrics logging: JSONL + optional TensorBoard and wandb.

The port's copy of ``mm_training_tpu/utils/logging.py`` (``MetricsLogger``,
``NullLogger``), which replaces the reference's Lightning self.log /
WandbLogger-or-TensorBoardLogger wiring (mm_training_aim.py:286-288,587).
It writes the same files: ``metrics.jsonl`` under the run's output path,
and the TensorBoard event files under ``tb/<experiment>`` when tensorboardX
is installed. wandb logs when installed and asked for. The image and 3D
scene panels (``log_image``, ``log_scene_3d``) wait with the renderer.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict

try:
    from tensorboardX import SummaryWriter
except ImportError:  # pragma: no cover
    SummaryWriter = None

try:
    import wandb
except ImportError:  # pragma: no cover
    wandb = None

__all__ = ['MetricsLogger', 'NullLogger']


class NullLogger:
    """A logger that writes nothing (the JAX package's logger of a
    multi-process run's ranks above 0)."""

    def log_step(self, step, metrics):
        pass

    def log_scalar(self, step, name, value):
        pass

    def log_eval(self, step, metrics):
        pass

    def close(self):
        pass


class MetricsLogger:
    def __init__(self, out_path, experiment_name: str, log_every: int = 50,
                 use_tensorboard: bool = True, use_wandb: bool = False):
        self.out_path = Path(out_path)
        self.out_path.mkdir(parents=True, exist_ok=True)
        self.log_every = log_every
        self.jsonl = open(self.out_path / 'metrics.jsonl', 'a')
        self.tb = (SummaryWriter(str(self.out_path / 'tb' / experiment_name))
                   if use_tensorboard and SummaryWriter is not None else None)
        self.wandb_run = None
        if use_wandb and wandb is not None:  # pragma: no cover
            self.wandb_run = wandb.init(project='mm_training_exp',
                                        name=experiment_name)
        self._t_last = time.time()
        self._step_last = 0

    def _emit(self, step: int, metrics: Dict[str, float]):
        rec = {'step': step, 'time': time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.jsonl.write(json.dumps(rec) + '\n')
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), step)
        if self.wandb_run is not None:  # pragma: no cover
            self.wandb_run.log(dict(metrics), step=step)

    def log_step(self, step: int, metrics):
        """Log a train step's metrics when ``step`` crosses a multiple of
        ``log_every``. An interval-crossing gate, not a modulo: under K-step
        dispatch the step counter advances by K a call. ``metrics`` may hold
        0-dim tensors on the card: they are read only here."""
        if step // self.log_every <= self._step_last // self.log_every:
            return
        now = time.time()
        sps = (step - self._step_last) / max(now - self._t_last, 1e-9)
        self._t_last, self._step_last = now, step
        m = {k: float(v) for k, v in metrics.items()}
        m['steps_per_sec'] = sps
        self._emit(step, m)

    def log_scalar(self, step: int, name: str, value: float):
        self._emit(step, {name: value})

    def log_eval(self, step: int, metrics: Dict[str, float]):
        self._emit(step, metrics)

    def close(self):
        """Flush and close the files (idempotent)."""
        if not self.jsonl.closed:
            self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
            self.tb = None
