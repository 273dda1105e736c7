from .base import (BBoxCoderConf, BDAAugConf, BEVBackboneConf, BEVNeckConf, BackboneConf, Config,
                   DepthNetConf, HeadConf, ImageBackboneConf, ImageNeckConf, LidarEncoderConf,
                   TaskConf, TestCfg, TrainCfg, VoxelizationConf)

__all__ = ['BBoxCoderConf', 'BDAAugConf', 'BEVBackboneConf', 'BEVNeckConf', 'BackboneConf',
           'Config', 'DepthNetConf', 'HeadConf', 'ImageBackboneConf', 'ImageNeckConf',
           'LidarEncoderConf', 'TaskConf', 'TestCfg', 'TrainCfg', 'VoxelizationConf']
