"""The port's camera train step against the JAX package's on the CPU on a
raw rig: LiDAR+camera with every camera pitched by 3 degrees, both models
on the general lift-splat (``factorized_splat=False``; kernel K8's plain
version and its autograd here) and the depth oracle off, so the DepthNet's
softmax depth of every frustum point reaches the splat and the detection
loss's gradient reaches it back. As ``test_torch_train_cam.py``, whose
docstring says what is compared, without the eval step;
``tests/torch_port_helpers.py::camera_train_parity_case`` states the
tolerances."""
import numpy as np
import pytest

from tests import torch_port_helpers as helpers

KW = dict(use_lidar=True, use_radar=False, use_depth_loss=False, pitch_deg=3.0,
          with_eval=False)


@pytest.fixture(scope='module')
def case():
    return helpers.camera_train_parity_case(**KW)


@pytest.fixture(scope='module')
def case64():
    return helpers.camera_train_parity_case(**KW, dtype=np.float64, rotated_bda=False)


def test_raw_rig_camera_train_step_loss_matches_jax(case, case64):
    assert case['flips'].any() and not case['flips'].all()
    helpers.check_train_metrics(case, case64)


def test_raw_rig_camera_train_step_gradients_match_jax(case64):
    helpers.check_train_gradients(case64)


def test_raw_rig_camera_train_step_update_matches_jax(case, case64):
    helpers.check_train_update(case, case64)


def test_raw_rig_camera_train_step_bn_stats_match_jax(case, case64):
    helpers.check_train_bn_stats(case, case64)
