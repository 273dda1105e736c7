"""The two sides of a cell: the program (the port's own entry points, on the
weights, batches and draws the benchmark makes) and the reference (the
plain copy under ``benchmark/reference``, float32 with TF32 off, or in the
control's float8 products), behind one interface the loops and the judge
read.

A fault (``FAULTS``) breaks the program's timed path underneath, for the
tests that show the comparison catches it: ``state_unchanged`` (a train step
that leaves the state as it was), ``half_batch`` (half of the batch left
out, the step's mean over the rest), and in a predict call
``answer_altered`` (one kept box moved and rescored where it is produced),
``valid_zeroed`` (every box marked not kept) and ``nms_skipped`` (the
decode without its circle NMS).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import configfile, weights

FAULTS = ('state_unchanged', 'half_batch', 'answer_altered', 'valid_zeroed', 'nms_skipped')


def _half(batch: Dict[str, Any], draws: Optional[Dict[str, Any]]):
    """The first half of a batch's rows (and of a camera step's draws)."""
    b = batch['gt_boxes'].shape[0]
    half = {k: v[:b // 2] for k, v in batch.items()}
    if draws is None:
        return half, None
    s, n = batch['imgs'].shape[1:3]
    return half, {'flipped': draws['flipped'][:b // 2 * s * n],
                  'dropout': [m[:b // 2 * n] for m in draws['dropout']]}


def _norms(tensors):
    return [float(n) for n in torch.stack(torch._foreach_norm(
        [t.detach().float() for t in tensors])).cpu()]


class _TrainSide:
    """What the judge reads of a training side: its model, its optimizer's
    first moments and ``b1``."""
    model: torch.nn.Module

    def grad_norms(self):
        mu, b1 = self.first_moments()
        return [n / (1.0 - b1) for n in _norms(mu)]

    def change_norms(self, initial: Dict[str, torch.Tensor]):
        named = list(self.model.named_parameters())
        return _norms([p.detach() - initial[n] for n, p in named])

    def leaf_names(self):
        return [n for n, _ in self.model.named_parameters()]

    def bn_names(self):
        return [n for n, _ in self.model.named_buffers()
                if n.endswith(('running_mean', 'running_var'))]

    def bn_norms(self):
        return _norms([b for n, b in self.model.named_buffers()
                       if n.endswith(('running_mean', 'running_var'))])


class PortTrain(_TrainSide):
    """The port's train step on the state ``create_train_state`` makes."""

    def __init__(self, cfg_dict, seed: int, device, fault: Optional[str] = None):
        from mm_training_tpu_torch.configs import Config
        from mm_training_tpu_torch.models import BEVDepthLiDAR
        from mm_training_tpu_torch.training import create_train_state, make_train_step
        self.cfg = configfile.build(Config, cfg_dict)
        self.model = BEVDepthLiDAR(self.cfg, device=device)
        weights.load(self.model, weights.make(self.model, seed,
                                              self.cfg.get_head_conf().init_bias, device))
        self.state = create_train_state(self.cfg, self.model)
        self._step = make_train_step(self.cfg)
        self.fault = fault

    def step(self, batch, draws):
        """One step; returns (loss, detection loss, depth loss) on the device."""
        if self.fault == 'half_batch':
            batch, draws = _half(batch, draws)
        if self.fault == 'state_unchanged':
            saved = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            opt = self.state.optimizer
            moments = [[t.clone() for t in opt.mu], [t.clone() for t in opt.nu], opt.count]
        self.state, m = self._step(self.state, batch, draws)
        if self.fault == 'state_unchanged':
            self.model.load_state_dict(saved)
            opt.mu, opt.nu, opt.count = moments
            self.state.step -= 1
        return m['train_loss'], m['train_detection_loss'], m['train_depth_loss']

    def first_moments(self):
        return self.state.optimizer.mu, self.state.optimizer.b1


class ReferenceTrain(_TrainSide):
    """The plain reference's train step and AdamW, float32 (TF32 off), or
    with float8 products as the control."""

    def __init__(self, cfg_dict, seed: int, device, fp8: bool = False):
        from ..reference import configs as rconfigs
        from ..reference.models import BEVDepthLiDAR
        from ..reference.optim import make_optimizer
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = configfile.build(rconfigs.Config, dict(cfg_dict, precision='fp32'))
        self.model = BEVDepthLiDAR(self.cfg, device=device)
        weights.load(self.model, weights.make(self.model, seed,
                                              self.cfg.get_head_conf().init_bias, device))
        self.opt = make_optimizer(self.cfg, self.model.parameters())
        self.fp8 = fp8
        if fp8:
            from ..reference import lowp
            lowp.round_products(self.model)

    def step(self, batch, draws):
        from ..reference import step as rstep
        weight_map = None
        if self.fp8:
            from ..reference import lowp
            weight_map = lowp.round_kernels
        loss, grads, parts = rstep.loss_and_grads(self.cfg, self.model, batch, draws, weight_map)
        self.opt.step(grads)
        return loss, parts['detection'], parts['depth']

    def first_moments(self):
        return self.opt.mu, self.opt.b1


class PortPredict:
    """The port's ``make_predict_step`` on the model with the benchmark's
    weights; a call returns its outputs copied to the host."""

    def __init__(self, cfg_dict, seed: int, device, fault: Optional[str] = None):
        from mm_training_tpu_torch.configs import Config
        from mm_training_tpu_torch.models import BEVDepthLiDAR
        from mm_training_tpu_torch.training import make_predict_step
        self.cfg = configfile.build(Config, cfg_dict)
        model = BEVDepthLiDAR(self.cfg, device=device)
        weights.load(model, weights.make(model, seed, self.cfg.get_head_conf().init_bias, device))
        self._predict = make_predict_step(self.cfg, model)
        self.fault = fault

    def __call__(self, batch):
        if self.fault == 'half_batch':
            b = batch['gt_boxes'].shape[0]
            batch = {k: np.concatenate([v[:b // 2]] * 2) for k, v in batch.items()}
        if self.fault == 'nms_skipped':
            from mm_training_tpu_torch.models import centerpoint_head
            nms = centerpoint_head.circle_nms
            centerpoint_head.circle_nms = SimpleNamespace(
                circle_nms_mask=lambda centers, scores, valid, thresh: valid)
            try:
                out = tuple(t.cpu() for t in self._predict(batch))
            finally:
                centerpoint_head.circle_nms = nms
        else:
            out = tuple(t.cpu() for t in self._predict(batch))
        if self.fault == 'valid_zeroed':
            out = out[:3] + (torch.zeros_like(out[3]),)
        if self.fault == 'answer_altered':
            boxes, scores = out[0].clone(), out[1].clone()
            boxes[0, 0, :2] += 1.0
            scores[0, 0] += 0.1
            out = (boxes, scores) + out[2:]
        return out


class ReferencePredict:
    """The plain reference's eval-mode forward and decode, float32 (TF32
    off), or with float8 products as the control: (decoded outputs on the
    host, float32 pred maps)."""

    def __init__(self, cfg_dict, seed: int, device, fp8: bool = False):
        from ..reference import configs as rconfigs
        from ..reference.models import BEVDepthLiDAR
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = configfile.build(rconfigs.Config, dict(cfg_dict, precision='fp32'))
        self.model = BEVDepthLiDAR(self.cfg, device=device)
        w = weights.make(self.model, seed, self.cfg.get_head_conf().init_bias, device)
        if fp8:
            from ..reference import lowp
            w = lowp.round_kernels(w)
            lowp.round_products(self.model)
        weights.load(self.model, w)

    def __call__(self, batch):
        from ..reference import step as rstep
        decoded, maps = rstep.predict(self.cfg, self.model, batch)
        return tuple(t.cpu() for t in decoded), maps
