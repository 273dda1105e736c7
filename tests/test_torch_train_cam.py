"""The port's LiDAR+camera train and eval steps against the JAX package's
``make_train_step`` / ``make_eval_step`` on the CPU (tiny config, narrow
widths, the depth oracle on, at least one image flipped, the JAX step's own
flips and dropout masks; one step from the same random variables, float32
with a rotated BEV augmentation and, for the gradients and the update,
float64). The tolerances, where each package rounds to float32 and how the
random draws are carried are stated in
``tests/torch_port_helpers.py::camera_train_parity_case``. One
configuration a file, so the JAX compiles spread over the workers:
LiDAR+radar+camera ``test_torch_train_cam_radar.py``, camera-only
``test_torch_train_cam_only.py``, the oracle off
``test_torch_train_cam_nooracle.py``, two sweeps
``test_torch_train_cam_sweeps.py``."""
import numpy as np
import pytest

from tests import torch_port_helpers as helpers

KW = dict(use_lidar=True, use_radar=False, use_depth_loss=True)


@pytest.fixture(scope='module')
def case():
    return helpers.camera_train_parity_case(**KW)


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


def test_camera_eval_step_matches_jax_on_padded_batch(case):
    helpers.check_eval_step(case)
