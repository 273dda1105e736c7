"""The camera serving slice on the CPU, LiDAR+camera (the ``lidar_cam``
variant's modalities) with ``use_depth_loss=False``: no depth oracle, so the
softmax depth of the DepthNet (through the deformable conv, kernel K5's
plain version) reaches the splat. The port's predict step against the JAX
package's (tests/torch_port_helpers.py::check_camera_predict_parity).
"""
from tests.torch_port_helpers import check_camera_predict_parity


def test_predict_matches_jax_lidar_cam_without_oracle():
    check_camera_predict_parity(use_radar=False, use_depth_loss=False, rotated_bda=False)


def test_predict_matches_jax_lidar_cam_raw_rig_without_oracle():
    """The raw-rig path: every camera pitched by 3 degrees and both models
    on the general splat (kernel K8's plain version here), the softmax depth
    of every frustum point lifted into its own cell."""
    check_camera_predict_parity(use_radar=False, use_depth_loss=False, rotated_bda=True,
                                pitch_deg=3.0)
