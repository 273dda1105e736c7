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
    """EMA (the runtime slice) is no longer refused: a ``use_ema`` state
    holds the shadow and a step moves it toward the stepped weights; the
    camera train and eval steps are ported (the camera training slice) and
    build for L+C and camera-only, and a camera step called without its
    random draws through ``loss_and_grads`` says so."""
    from mm_training_tpu_torch.training import loss_and_grads
    cfg = tiny_test_config(use_cam=False, use_ema=True)
    state = create_train_state(cfg, BEVDepthLiDAR(cfg, device='cpu'), steps_per_epoch=10)
    before = {k: v.clone() for k, v in state.ema.items()}
    state, _ = make_train_step(cfg)(state, make_fake_batch(cfg, seed=0))
    live = state.model.state_dict()
    name = 'head.shared_conv.conv.weight'
    assert not torch.equal(state.ema[name], before[name])
    assert (state.ema[name] - live[name]).abs().max() < (before[name] - live[name]).abs().max()
    for cam in (tiny_test_config(use_cam=True), tiny_test_config(use_cam=True, use_lidar=False)):
        assert callable(make_train_step(cam)) and callable(make_eval_step(cam))
    cam = tiny_test_config(use_cam=True)
    state = create_train_state(cam, BEVDepthLiDAR(cam, device='cpu'), steps_per_epoch=10)
    with pytest.raises(ValueError, match='random draws'):
        loss_and_grads(cam, state, make_fake_batch(cam, seed=0))


def test_raw_rig_camera_model_builds_and_steps():
    """The raw-rig camera model (``factorized_splat=False``, the general
    splat) builds on the CPU, serves a pitched rig and takes train steps
    with the oracle on and off (finite losses, the parameters move) and an
    eval step; on the card a camera width the raw-rig kernels do not take
    is refused where the model is built, naming the knob."""
    import dataclasses
    from mm_training_tpu_torch.configs import raw_rig
    from mm_training_tpu_torch.models.bev_depth import check_card_limits
    from mm_training_tpu_torch.training import make_predict_step
    cfg = raw_rig(tiny_test_config(use_cam=True))
    model = BEVDepthLiDAR(cfg, device='cpu')
    batch = make_fake_batch(cfg, seed=0, pitch_deg=3.0)
    boxes, scores, _, valid = make_predict_step(cfg, model)(batch)
    assert boxes.shape == (2, 4 * 83, 9) and torch.isfinite(scores).all() and valid.any()
    state = create_train_state(cfg, model, steps_per_epoch=10)
    before = [p.detach().clone() for p in model.parameters()]
    for c in (cfg, cfg.replace(use_depth_loss=False)):
        state, metrics = make_train_step(c)(state, batch)
        assert torch.isfinite(metrics['train_loss']) and metrics['train_depth_loss'] > 0
    assert state.step == 2
    assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    ev, (boxes, _, _, _), _ = make_eval_step(cfg)(state, batch)
    assert torch.isfinite(ev['loss']) and torch.isfinite(boxes).all()
    for c in (8, 256):
        wide = cfg.replace(backbone_conf=dataclasses.replace(cfg.get_backbone_conf(),
                                                             output_channels=c))
        check_card_limits(wide, 'cuda')
    for c in (12, 264):
        wide = cfg.replace(backbone_conf=dataclasses.replace(cfg.get_backbone_conf(),
                                                             output_channels=c))
        with pytest.raises(ValueError, match='BackboneConf.output_channels'):
            check_card_limits(wide, 'cuda')
        check_card_limits(wide, 'cpu')
        check_card_limits(wide.replace(backbone_conf=dataclasses.replace(
            wide.get_backbone_conf(), factorized_splat=True)), 'cuda')
