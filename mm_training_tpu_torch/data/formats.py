"""aiMotive dataset file-format structures.

The port's copy of ``mm_training_tpu/data/formats.py``. Re-design of
dataset/src/{annotation.py, sequence.py, camera_params.py}: annotation
JSONs (CapturedObjects schema), 15-second sequence keyframe indexing, and
the camera parameter container.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

__all__ = ['Annotation', 'Sequence', 'CameraParams', 'object_to_array']


class Annotation:
    """Per-keyframe 3D box annotations (dataset/src/annotation.py).

    The JSON schema stores per object: BoundingBox3D Origin X/Y/Z (gravity
    center), Extent X/Y/Z, Orientation Quat X/Y/Z/W, Relative Velocity X/Y/Z,
    ObjectType; Occluded/Truncated carry dummy values and are dropped.
    """

    def __init__(self, path: str):
        self.path = path
        with open(path) as f:
            data = json.load(f)
        self.objects = [self._strip(o) for o in data.get('CapturedObjects', [])]

    @staticmethod
    def _strip(obj: Dict) -> Dict:
        obj.pop('Occluded', None)
        obj.pop('Truncated', None)
        return obj


def object_to_array(obj: Dict):
    """JSON object -> [x, y, z, dx, dy, dz, yaw, vx, vy] + type name
    (dataset/src/data_loader.py:242-260)."""
    from ..core.transforms import quat_to_yaw
    yaw = quat_to_yaw(obj['BoundingBox3D Orientation Quat X'],
                      obj['BoundingBox3D Orientation Quat Y'],
                      obj['BoundingBox3D Orientation Quat Z'],
                      obj['BoundingBox3D Orientation Quat W'])
    # velocity: dataset schema uses 'Relative Velocity *'; tolerate the
    # 'BoundingBox3D Relative Velocity *' keys the reference exporter wrote
    vx = obj.get('Relative Velocity X',
                 obj.get('BoundingBox3D Relative Velocity X', 0.0))
    vy = obj.get('Relative Velocity Y',
                 obj.get('BoundingBox3D Relative Velocity Y', 0.0))
    arr = [obj['BoundingBox3D Origin X'], obj['BoundingBox3D Origin Y'],
           obj['BoundingBox3D Origin Z'], obj['BoundingBox3D Extent X'],
           obj['BoundingBox3D Extent Y'], obj['BoundingBox3D Extent Z'],
           yaw, vx, vy]
    return arr, obj['ObjectType']


class Sequence:
    """A 15-second recording -> sorted keyframe annotation paths under
    dynamic/box/3d_body, trimmed by the temporal-aggregation window
    (dataset/src/sequence.py)."""

    def __init__(self, path: str, look_back: int = 0, look_forward: int = 0):
        self.path = path
        frames = sorted(os.listdir(os.path.join(path, 'dynamic', 'box', '3d_body')))
        frames = frames[look_back:]
        if look_forward > 0:
            frames = frames[:-look_forward]
        self.keyframes = frames

    def get_frames(self) -> List[str]:
        return [os.path.join(self.path, 'dynamic', 'box', '3d_body', k)
                for k in self.keyframes]


@dataclass
class CameraParams:
    """Camera parameter container (dataset/src/camera_params.py).

    intrinsic: [3, 4] ray-to-image; extrinsic: [4, 4] body-to-sensor.
    """
    intrinsic: np.ndarray
    extrinsic: np.ndarray
    dist_coeffs: np.ndarray
    camera_model: str
    xi: Optional[float] = None

    @property
    def focal_length(self):
        return [self.intrinsic[0][0], self.intrinsic[1][1]]

    @property
    def principal_point(self):
        return [self.intrinsic[0][2], self.intrinsic[1][2]]
