from .bev_depth import BEVDepthLiDAR
from .centerpoint_head import decode_boxes, detection_loss, get_targets

__all__ = ['BEVDepthLiDAR', 'decode_boxes', 'detection_loss', 'get_targets']
