from .cameras import (CameraEquirect, CameraMei, CameraModel, CameraPinhole,
                      CameraPinholeDistorted, make_from_dict, make_from_json)

__all__ = ['CameraEquirect', 'CameraMei', 'CameraModel', 'CameraPinhole',
           'CameraPinholeDistorted', 'make_from_dict', 'make_from_json']
