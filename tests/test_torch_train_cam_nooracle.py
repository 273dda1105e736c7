"""The port's camera train and eval steps against the JAX package's on the
CPU, LiDAR+camera with the depth oracle off (the DepthNet's predicted depth
reaches the splat, so the detection loss's gradient reaches it through
kernel K4's backward too): as ``test_torch_train_cam.py``, whose docstring
says what is compared;
``tests/torch_port_helpers.py::camera_train_parity_case`` states the
tolerances."""
import numpy as np
import pytest

from tests import torch_port_helpers as helpers

KW = dict(use_lidar=True, use_radar=False, use_depth_loss=False)


@pytest.fixture(scope='module')
def case():
    # the eval step is held in test_torch_train_cam.py, _radar.py and _only.py
    return helpers.camera_train_parity_case(**KW, with_eval=False)


@pytest.fixture(scope='module')
def case64():
    return helpers.camera_train_parity_case(**KW, dtype=np.float64, with_eval=False,
                                            rotated_bda=False)


def test_camera_train_step_loss_matches_jax(case, case64):
    assert case['flips'].any() and not case['flips'].all()
    helpers.check_train_metrics(case, case64)


def test_camera_train_step_gradients_match_jax(case64):
    helpers.check_train_gradients(case64)


def test_camera_train_step_update_matches_jax(case, case64):
    helpers.check_train_update(case, case64)


def test_camera_train_step_bn_stats_match_jax(case, case64):
    helpers.check_train_bn_stats(case, case64)

