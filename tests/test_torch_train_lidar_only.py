"""The port's LiDAR-only train and eval steps against the JAX package's
(see ``test_torch_train.py`` for the LiDAR+radar case and
``tests/torch_port_helpers.py`` for the tolerances)."""
import numpy as np
import pytest

from tests import torch_port_helpers as helpers


@pytest.fixture(scope='module')
def case():
    return helpers.train_parity_case(use_radar=False)


@pytest.fixture(scope='module')
def case64():
    return helpers.train_parity_case(use_radar=False, dtype=np.float64)


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
