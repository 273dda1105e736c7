"""The whole serving slice on the CPU, LiDAR+radar (the lidar_radar variant's modalities): the port's predict step
against the JAX package's ``make_predict_step``
(tests/torch_port_helpers.py::check_predict_parity). One case per file:
importing the JAX training package alone takes most of a file's budget.
"""
from tests.torch_port_helpers import check_predict_parity


def test_predict_matches_jax_lidar_radar():
    check_predict_parity(use_radar=True)
