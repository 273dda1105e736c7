"""The camera serving slice on the CPU, LiDAR+radar+camera (the
``lidar_cam_radar`` variant's modalities) with the LiDAR depth oracle on and
a rotated, flipped and scaled BEV augmentation: the port's predict step
against the JAX package's
(tests/torch_port_helpers.py::check_camera_predict_parity). One case per
file: importing the JAX training package alone takes most of a file's
budget.
"""
from tests.torch_port_helpers import check_camera_predict_parity


def test_predict_matches_jax_lidar_cam_radar_oracle_rotated_bda():
    check_camera_predict_parity(use_radar=True, use_depth_loss=True, rotated_bda=True)
