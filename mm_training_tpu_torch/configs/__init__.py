from .base import (CATEGORY_MAPPING, CLASSES, BBoxCoderConf, BDAAugConf, BEVBackboneConf,
                   BEVNeckConf, BackboneConf, Config, DepthNetConf, HeadConf, ImageBackboneConf,
                   ImageNeckConf, LidarEncoderConf, TaskConf, TestCfg, TrainCfg, VoxelizationConf)
from .variants import (NUSC_MIN_RADIUS, NUSC_TASK_CLASSES, eval_lidar_only, eval_lidar_radar,
                       lidar_cam, lidar_cam_radar, lidar_only, lidar_radar, nuscenes_tasks,
                       raw_rig, tiny_test_config)

__all__ = ['CATEGORY_MAPPING', 'CLASSES', 'NUSC_MIN_RADIUS', 'NUSC_TASK_CLASSES', 'BBoxCoderConf', 'BDAAugConf', 'BEVBackboneConf',
           'BEVNeckConf', 'BackboneConf', 'Config', 'DepthNetConf', 'HeadConf',
           'ImageBackboneConf', 'ImageNeckConf', 'LidarEncoderConf', 'TaskConf', 'TestCfg',
           'TrainCfg', 'VoxelizationConf', 'eval_lidar_only', 'eval_lidar_radar', 'lidar_cam',
           'lidar_cam_radar', 'lidar_only', 'lidar_radar', 'nuscenes_tasks', 'raw_rig',
           'tiny_test_config']
