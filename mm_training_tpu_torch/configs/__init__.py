from .base import (BBoxCoderConf, BDAAugConf, BEVBackboneConf, BEVNeckConf, BackboneConf,
                   Config, DepthNetConf, HeadConf, ImageBackboneConf, ImageNeckConf,
                   LidarEncoderConf, TaskConf, TestCfg, TrainCfg, VoxelizationConf)
from .variants import (lidar_cam, lidar_cam_radar, lidar_only, lidar_radar, raw_rig,
                       tiny_test_config)

__all__ = ['BBoxCoderConf', 'BDAAugConf', 'BEVBackboneConf', 'BEVNeckConf', 'BackboneConf',
           'Config', 'DepthNetConf', 'HeadConf', 'ImageBackboneConf', 'ImageNeckConf',
           'LidarEncoderConf', 'TaskConf', 'TestCfg', 'TrainCfg', 'VoxelizationConf',
           'lidar_cam', 'lidar_cam_radar', 'lidar_only', 'lidar_radar', 'raw_rig',
           'tiny_test_config']
