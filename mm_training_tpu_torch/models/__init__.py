from .bev_depth import BEVDepthLiDAR
from .centerpoint_head import (BEVDepthHead, SeparateHead, decode_boxes, detection_loss,
                               get_targets)
from .lidar_encoder import LidarBEVEncoder
from .resnet import BasicBlock, ConvBN, ResNet, space_to_depth_2x2
from .second_fpn import SECONDFPN
from .weights import state_dict_from_flax

__all__ = ['BEVDepthLiDAR', 'BEVDepthHead', 'SeparateHead', 'decode_boxes',
           'detection_loss', 'get_targets', 'LidarBEVEncoder', 'BasicBlock', 'ConvBN',
           'ResNet', 'space_to_depth_2x2', 'SECONDFPN', 'state_dict_from_flax']
