"""The port's LiDAR+radar train and eval steps against the JAX package's
``make_train_step`` / ``make_eval_step`` on the CPU (tiny config, narrow
widths, one step from the same random variables, in float32 and, for the
gradients and the update, float64); the tolerances and the reason for
float64 are stated in ``tests/torch_port_helpers.py``. The LiDAR-only case is
``test_torch_train_lidar_only.py`` (a file of its own, so the two JAX
compiles run on two workers)."""
import numpy as np
import pytest
import torch

import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu_torch.configs import tiny_test_config
from mm_training_tpu_torch.data import make_fake_batch
from mm_training_tpu_torch.models import BEVDepthLiDAR
from mm_training_tpu_torch.training import (create_train_state, make_eval_step,
                                            make_train_step)
from tests import torch_port_helpers as helpers


@pytest.fixture(scope='module')
def case():
    return helpers.train_parity_case(use_radar=True)


@pytest.fixture(scope='module')
def case64():
    return helpers.train_parity_case(use_radar=True, dtype=np.float64)


def test_train_step_loss_matches_jax(case, case64):
    helpers.check_train_metrics(case, case64)


def test_train_step_gradients_match_jax(case64):
    helpers.check_train_gradients(case64)


def test_train_step_update_matches_jax(case, case64):
    helpers.check_train_update(case, case64)


def test_train_step_bn_stats_match_jax(case, case64):
    helpers.check_train_bn_stats(case, case64)


def test_eval_step_matches_jax_on_padded_batch(case):
    helpers.check_eval_step(case)


def test_train_loss_falls_on_one_batch():
    """A short overfit on one batch: the loss falls and stays finite."""
    cfg = helpers.narrow(tcfg, tiny_test_config(use_cam=False))
    state = create_train_state(cfg, BEVDepthLiDAR(cfg, device='cpu'), steps_per_epoch=10)
    step = make_train_step(cfg)
    batch = make_fake_batch(cfg, seed=0)
    losses = []
    for _ in range(6):
        state, metrics = step(state, batch)
        losses.append(float(metrics['train_loss']))
        assert torch.isfinite(metrics['grad_norm'])
    assert state.step == 6 and state.optimizer.count == 6
    assert losses[-1] < 0.7 * losses[0], losses


def test_steps_refuse_what_later_slices_bring():
    """EMA (the runtime slice) and the raw-rig splat (kernel K8) are still
    refused; the camera train and eval steps are ported (the camera
    training slice) and build for L+C and camera-only, and a camera step
    called without its random draws through ``loss_and_grads`` says so."""
    import dataclasses
    from mm_training_tpu_torch.training import loss_and_grads
    cfg = tiny_test_config(use_cam=False)
    with pytest.raises(NotImplementedError, match='runtime slice .slice 5.'):
        make_train_step(cfg.replace(use_ema=True))
    with pytest.raises(NotImplementedError, match='runtime slice .slice 5.'):
        create_train_state(cfg.replace(use_ema=True), BEVDepthLiDAR(cfg, device='cpu'))
    for cam in (tiny_test_config(use_cam=True), tiny_test_config(use_cam=True, use_lidar=False)):
        assert callable(make_train_step(cam)) and callable(make_eval_step(cam))
    cam = tiny_test_config(use_cam=True)
    raw = cam.replace(backbone_conf=dataclasses.replace(cam.get_backbone_conf(),
                                                        factorized_splat=False))
    with pytest.raises(NotImplementedError, match='raw-rig'):
        BEVDepthLiDAR(raw, device='cpu')
    state = create_train_state(cam, BEVDepthLiDAR(cam, device='cpu'), steps_per_epoch=10)
    with pytest.raises(ValueError, match='random draws'):
        loss_and_grads(cam, state, make_fake_batch(cam, seed=0))
