"""Frozen copy of the port's ``training/optim.py`` for the benchmark's reference, run
on its plain path (its kernel calls bound to their plain versions, one
process). The text below is the original's.

Optimizer and LR schedule: global-norm clip, then AdamW, optax's numbers.

The port of ``mm_training_tpu/training/optim.py``, which chains
``optax.clip_by_global_norm(gradient_clip_val)`` and ``optax.adamw(schedule,
weight_decay)`` (reference mm_training_aim.py:524-531,626: AdamW, weight
decay 1e-7, MultiStepLR at epoch milestones with gamma 0.1, clip at 2.0,
lr = base/64 * batch). Written out rather than ``torch.optim.AdamW`` plus
``clip_grad_norm_``, which differ in their details:

* the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``,
  with no epsilon (``clip_grad_norm_`` adds 1e-6 to the norm);
* Adam: ``mu = 0.9 mu + 0.1 g``, ``nu = 0.999 nu + 0.001 g^2``, bias
  correction with the incremented count, ``eps`` = 1e-8 outside the square
  root;
* decoupled weight decay on every parameter (BN scales and biases too),
  added to the Adam direction before the learning rate scales it:
  ``p += -lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)``;
* the learning rate is read at the count before the update.

The update runs on lists of tensors with ``torch._foreach_*`` (a handful of
launches per step rather than several per parameter) and never waits for
the device.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Sequence

import numpy as np
import torch

from .configs import Config

__all__ = ['AdamW', 'make_optimizer', 'multistep_schedule']


def multistep_schedule(base_lr: float, milestones_epochs: Sequence[int], gamma: float,
                       steps_per_epoch: int) -> Callable[[int], float]:
    """optax ``piecewise_constant_schedule``: ``base_lr`` times ``gamma``
    for every boundary ``milestone * steps_per_epoch`` the step has reached,
    each product rounded to float32 as optax's is."""
    boundaries = sorted(int(m) * steps_per_epoch for m in milestones_epochs)

    def schedule(step: int) -> float:
        v = np.float32(base_lr)
        for b in boundaries:
            if step >= b:
                v = np.float32(np.float32(gamma) * v)
        return float(v)

    return schedule


class AdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule,
    weight_decay))`` over a fixed list of float32 parameters, updated in
    place. ``mu``, ``nu`` and ``count`` are its state."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Callable[[int], float],
                 max_norm: float, weight_decay: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.schedule, self.max_norm, self.weight_decay = schedule, max_norm, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Apply one update for ``grads`` (one per parameter, in order);
        returns the global norm of the unclipped gradients (a 0-dim tensor
        on the parameters' device)."""
        grads = list(grads)
        if len(grads) != len(self.params):
            raise ValueError(f'AdamW.step: {len(grads)} gradients for '
                             f'{len(self.params)} parameters')
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax: g if norm < max_norm else (g / norm) * max_norm
        factor = torch.where(norm < self.max_norm, torch.ones_like(norm),
                             self.max_norm / norm)
        g = torch._foreach_mul(grads, factor)
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
        one = np.float32(1)   # optax forms 1 - b ** count in float32
        mu_hat = torch._foreach_div(self.mu, float(one - np.float32(b1) ** self.count))
        nu_hat = torch._foreach_div(self.nu, float(one - np.float32(b2) ** self.count))
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_add_(upd, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)
        return norm


def make_optimizer(cfg: Config, params: Iterable[torch.Tensor],
                   steps_per_epoch: int = 1000, global_batch_scale: int = 1) -> AdamW:
    """The config's optimizer over ``params``: lr = ``cfg.learning_rate *
    global_batch_scale``, stepped down by ``lr_gamma`` at each of
    ``lr_milestones`` (epochs of ``steps_per_epoch`` steps). The scale is the
    data-parallel size (JAX ``trainer.py:176``), not the world's: model
    peers share their rows."""
    schedule = multistep_schedule(cfg.learning_rate * global_batch_scale,
                                  cfg.lr_milestones, cfg.lr_gamma, steps_per_epoch)
    return AdamW(params, schedule, cfg.gradient_clip_val, cfg.weight_decay)
