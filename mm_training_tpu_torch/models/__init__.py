from .bev_depth import BEVDepthLiDAR
from .centerpoint_head import (BEVDepthHead, SeparateHead, decode_boxes, detection_loss,
                               get_targets)
from .depth_net import ASPP, DeformConv2d, DepthNet
from .fusion import BEVFuseLayer
from .lidar_encoder import LidarBEVEncoder
from .lss_fpn import LSSFPN
from .resnet import BasicBlock, Bottleneck, ConvBN, ResNet, space_to_depth_2x2
from .second_fpn import SECONDFPN
from .weights import state_dict_from_flax

__all__ = ['BEVDepthLiDAR', 'BEVDepthHead', 'SeparateHead', 'decode_boxes',
           'detection_loss', 'get_targets', 'ASPP', 'DeformConv2d', 'DepthNet',
           'BEVFuseLayer', 'LidarBEVEncoder', 'LSSFPN', 'BasicBlock', 'Bottleneck', 'ConvBN',
           'ResNet', 'space_to_depth_2x2', 'SECONDFPN', 'state_dict_from_flax']
