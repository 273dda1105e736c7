"""Experiment variants — data, not file copies (the port's copy of
``mm_training_tpu/configs/variants.py``)."""
from __future__ import annotations

import dataclasses

from .base import (BackboneConf, Config, DepthNetConf, ImageBackboneConf,
                   ImageNeckConf, LidarEncoderConf, VoxelizationConf)


def lidar_only(**kw) -> Config:
    """exps/configs/lidar_only.py: LiDAR-only, batch 4."""
    base = dict(experiment_name='lidar_only', batch_size=4,
                use_cam=False, use_lidar=True, use_radar=False,
                use_depth_loss=False)
    base.update(kw)
    return Config(**base)


def lidar_radar(**kw) -> Config:
    """exps/configs/lidar_radar.py: LiDAR+radar, batch 4."""
    base = dict(experiment_name='lidar_radar', batch_size=4,
                use_cam=False, use_lidar=True, use_radar=True,
                use_depth_loss=False)
    base.update(kw)
    return Config(**base)


def lidar_cam(**kw) -> Config:
    """exps/configs/lidar_cam.py: LiDAR+camera, batch 4."""
    base = dict(experiment_name='lidar_cam', batch_size=4,
                use_cam=True, use_lidar=True, use_radar=False,
                use_depth_loss=True)
    base.update(kw)
    return Config(**base)


def lidar_cam_radar(**kw) -> Config:
    """exps/configs/lidar_cam_radar.py: full fusion, batch 4, lr 3e-4/64*b."""
    base = dict(experiment_name='lidar_radar_cam', batch_size=4,
                use_cam=True, use_lidar=True, use_radar=True,
                use_depth_loss=True, base_learning_rate=3e-4)
    base.update(kw)
    return Config(**base)


def tiny_test_config(use_cam: bool = False, use_lidar: bool = True,
                     use_radar: bool = True, **kw) -> Config:
    """The JAX package's miniature CPU-test geometry: 51.2 x 25.6 m range,
    256x128 grid, 64x128 images from 2 cameras, 50 depth bins, tiny
    capacities, fp32."""
    pc = (-25.6, -12.8, -5.0, 25.6, 12.8, 3.0)
    base = dict(
        experiment_name='tiny', batch_size=2,
        H=64, W=128,
        precision='fp32',
        point_cloud_range=pc,
        use_cam=use_cam, use_lidar=use_lidar, use_radar=use_radar,
        use_depth_loss=use_cam,
        max_points_per_frame=2048,
        max_objs=32,
        num_cameras=2,
        backbone_conf=BackboneConf(
            x_bound=(pc[0], pc[3], 0.8), y_bound=(pc[1], pc[4], 0.8),
            z_bound=(pc[2], pc[5], 8.0), d_bound=(2.0, 27.2, 0.5),
            final_dim=(64, 128), output_channels=80, downsample_factor=16,
            img_backbone_conf=ImageBackboneConf(depth=18),
            img_neck_conf=ImageNeckConf(in_channels=(64, 128, 256, 512)),
            depth_net_conf=DepthNetConf(in_channels=512, mid_channels=64),
        ),
        lidar_conf=LidarEncoderConf(
            voxelization=VoxelizationConf(max_num_points=8, max_voxels=1024),
        ),
    )
    base.update(kw)
    return Config(**base)


def raw_rig(cfg: Config) -> Config:
    """``cfg`` with the general lift-splat (kernel K8) in place of the
    row-factorized one: ``BackboneConf.factorized_splat=False``, what the
    JAX trainer switches to for a rig with roll, pitch or intrinsic skew
    (``mm_training_tpu/training/trainer.py::_disable_factorized_splat``)."""
    return cfg.replace(backbone_conf=dataclasses.replace(cfg.get_backbone_conf(),
                                                         factorized_splat=False))
