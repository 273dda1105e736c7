"""Experiment variants — data, not file copies (the port's copy of
``mm_training_tpu/configs/variants.py``, lidar variants only)."""
from __future__ import annotations

from .base import Config, LidarEncoderConf, VoxelizationConf


def lidar_only(**kw) -> Config:
    """exps/configs/lidar_only.py: LiDAR-only, batch 4."""
    base = dict(experiment_name='lidar_only', batch_size=4,
                use_cam=False, use_lidar=True, use_radar=False)
    base.update(kw)
    return Config(**base)


def lidar_radar(**kw) -> Config:
    """exps/configs/lidar_radar.py: LiDAR+radar, batch 4."""
    base = dict(experiment_name='lidar_radar', batch_size=4,
                use_cam=False, use_lidar=True, use_radar=True)
    base.update(kw)
    return Config(**base)


def tiny_test_config(use_cam: bool = False, use_lidar: bool = True,
                     use_radar: bool = True, **kw) -> Config:
    """The JAX package's miniature CPU-test geometry: 51.2 x 25.6 m range,
    256x128 grid, tiny capacities, fp32."""
    pc = (-25.6, -12.8, -5.0, 25.6, 12.8, 3.0)
    base = dict(
        experiment_name='tiny', batch_size=2,
        precision='fp32',
        point_cloud_range=pc,
        use_cam=use_cam, use_lidar=use_lidar, use_radar=use_radar,
        max_points_per_frame=2048,
        max_objs=32,
        lidar_conf=LidarEncoderConf(
            voxelization=VoxelizationConf(max_num_points=8, max_voxels=1024),
        ),
    )
    base.update(kw)
    return Config(**base)
