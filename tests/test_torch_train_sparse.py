"""The port's train step with the sparse-import LiDAR encoder
(``LidarEncoderConf.variant='sparse_import'``: K1's sparse mode with the
first-K cap, the masked BNs through kernel A's masked form and its
backward) against the JAX package's ``make_train_step`` on the CPU:
``tiny_test_config`` LiDAR+radar at narrow widths, one step from the same
random variables in float64, where the gradients, the update and the BN
statistics are held (``tests/torch_port_helpers.py::train_parity_case``
states the tolerances and why). Float64 only: the JAX step with the sparse
encoder compiles slowly, and the float32 case of the dense step
(``test_torch_train.py``) covers the float32 path and the eval step."""
import numpy as np
import pytest

from tests import torch_port_helpers as helpers


@pytest.fixture(scope='module')
def case64():
    return helpers.train_parity_case(use_radar=True, dtype=np.float64,
                                     lidar_variant='sparse_import')


def test_sparse_train_step_loss_matches_jax(case64):
    helpers.check_train_metrics(case64, case64)


def test_sparse_train_step_gradients_match_jax(case64):
    helpers.check_train_gradients(case64)
    assert sum(n.startswith('lidar_encoder.pts_middle_encoder.') for n in case64['p_mu']) == 63


def test_sparse_train_step_update_matches_jax(case64):
    helpers.check_train_update(case64, case64)


def test_sparse_train_step_masked_bn_stats_match_jax(case64):
    """Every running statistic, the encoder's masked ones (flax's masked
    fast-variance statistics, momentum 0.99) among them, to 1e-5."""
    helpers.check_train_bn_stats(case64, case64)
    assert sum(n.startswith('lidar_encoder.') and n.endswith('running_var')
               for n in case64['p_stats']) == 21
