from .geometry import (create_frustum, flat_bev_index, get_geometry, quantize_geometry,
                       rig_is_row_independent)

__all__ = ['create_frustum', 'flat_bev_index', 'get_geometry', 'quantize_geometry',
           'rig_is_row_independent']
