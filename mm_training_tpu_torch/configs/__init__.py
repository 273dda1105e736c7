from .base import (BBoxCoderConf, BEVBackboneConf, BEVNeckConf, Config,
                   HeadConf, LidarEncoderConf, TaskConf, TestCfg, TrainCfg,
                   VoxelizationConf)
from .variants import lidar_only, lidar_radar, tiny_test_config

__all__ = ['BBoxCoderConf', 'BEVBackboneConf', 'BEVNeckConf', 'Config',
           'HeadConf', 'LidarEncoderConf', 'TaskConf', 'TestCfg', 'TrainCfg',
           'VoxelizationConf', 'lidar_only', 'lidar_radar', 'tiny_test_config']
