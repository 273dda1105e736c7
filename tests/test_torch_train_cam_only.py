"""The port's camera train and eval steps against the JAX package's on the
CPU, camera-only (``use_lidar=False``: the camera BEV feeds the head
directly), the depth oracle on: as ``test_torch_train_cam.py``, whose
docstring says what is compared;
``tests/torch_port_helpers.py::camera_train_parity_case`` states the
tolerances."""
import numpy as np
import pytest

from tests import torch_port_helpers as helpers

KW = dict(use_lidar=False, use_radar=False, use_depth_loss=True)


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
