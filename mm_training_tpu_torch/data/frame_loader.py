"""Multimodal frame assembly (host-side), LiDAR and radar.

The port's copy of ``mm_training_tpu/data/frame_loader.py`` on the LiDAR
and radar path, its arithmetic unchanged: lidar+radar concat into
8-feature points (the native ``concat_filter``), range filtering,
timestamp normalization, annotation -> array conversion with category
mapping, and the >5-lidar-points annotation filter (JAX :75-134). The
camera half (images, virtualization to zero-roll/pitch pinholes, the
camera-only field-of-view filter) waits for the camera data slice: a
``use_cam=True`` loader raises.

Documented deviations from the reference, as in the JAX package:
  * the pc-range filter tests x and y only: the reference's z test is lost
    to a numpy 3-argument ``logical_and`` misuse (data_loader.py:332-337);
    z is range-limited at voxelization anyway.
  * with use_cam=False no image file is decoded (the reference still reads
    the front JPG it never uses).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import numpy as np

from ..configs import CATEGORY_MAPPING
from .formats import Annotation, object_to_array
from .loaders import CAMERA_SLICE, CameraFrame, load_camera_data, load_lidar_data, load_radar_data
from .native import concat_filter_native

__all__ = ['FrameLoader', 'FrameData']


@dataclass
class FrameData:
    """One assembled keyframe (reference DataItem)."""
    path: str
    points: np.ndarray              # [N, F] (F=8 with radar, else 5)
    cameras: List[CameraFrame]      # calibration only: no image
    camera_timestamp: float
    objects: np.ndarray             # [K, 10] = box9 + class id


class FrameLoader:
    """Loads and assembles sensor data for a keyframe path."""

    def __init__(self, split: str, pc_range, use_cam=True, use_lidar=True,
                 use_radar=True, look_back=0, look_forward=0,
                 defer_processing: bool = False):
        if use_cam:
            raise NotImplementedError(CAMERA_SLICE)
        self.split = split
        self.pc_range = pc_range
        self.use_lidar = use_lidar
        self.use_radar = use_radar
        self.look_back = look_back
        self.look_forward = look_forward
        # defer_processing: skip ts-normalization / intensity / cap here so
        # the dataset can run them fused with BDA+pad in the native packer
        self.defer_processing = defer_processing
        self.max_points = (look_back + look_forward + 1) * 100_000

    # ------------------------------------------------------------- assembly
    def __getitem__(self, path: str) -> FrameData:
        data_folder = self._sequence_dir(path)
        frame_id = self._frame_id(path)
        ann = Annotation(path)
        lidar = load_lidar_data(data_folder, frame_id, self.look_back,
                                self.look_forward)
        camera_data = load_camera_data(data_folder, frame_id, False)

        if self.use_radar:
            radar = load_radar_data(data_folder, frame_id)
            radar_pts = np.concatenate([radar['B_LRR_C'], radar['F_LRR_C']],
                                       axis=0)
            points = concat_filter_native(lidar, radar_pts, self.pc_range,
                                          camera_data.timestamp)
        else:
            points = self._filter_range(lidar)

        if self.defer_processing:
            cam_ts = float(camera_data.timestamp)  # raw; packer normalizes
        else:
            # normalize timestamps to [0, 1] over the aggregated cloud
            # (data_loader.py:100-103)
            ts = points[:, -1] if len(points) else np.zeros(1, np.float32)
            ts_min, ts_max = float(ts.min()), float(ts.max())
            denom = (ts_max - ts_min) or 1.0
            if len(points):
                points[:, -1] = (points[:, -1] - ts_min) / denom
            cam_ts = (camera_data.timestamp - ts_min) / denom
            points = self._process_points(points)

        rows = []
        for arr, type_name in (object_to_array(o) for o in ann.objects):
            if type_name in CATEGORY_MAPPING:
                rows.append(arr + [CATEGORY_MAPPING[type_name]])
        obj_arr = (np.asarray(rows, np.float32) if rows
                   else np.zeros((0, 10), np.float32))

        if self.use_lidar:
            # the reference counts LIDAR returns only (data_loader.py:130
            # tests lidar_data.top_lidar); with radar fused the 8-feature
            # concat carries is_radar at column 3 — exclude those rows so a
            # box with <=5 lidar returns isn't kept by its radar targets
            lidar_only = points[points[:, 3] == 0.0] if self.use_radar else points
            obj_arr = self._filter_objects_by_num_points(obj_arr, lidar_only)

        return FrameData(path=path, points=points, cameras=camera_data.items,
                         camera_timestamp=cam_ts, objects=obj_arr)

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _sequence_dir(path: str) -> str:
        parts = os.path.normpath(path).split(os.path.sep)[:-4]
        return os.path.sep.join(parts)

    @staticmethod
    def _frame_id(path: str) -> str:
        name = os.path.splitext(os.path.basename(os.path.normpath(path)))[0]
        return name.split('_')[1]

    def _filter_range(self, pc: np.ndarray) -> np.ndarray:
        r = self.pc_range
        keep = ((pc[:, 0] > r[0]) & (pc[:, 0] < r[3])
                & (pc[:, 1] > r[1]) & (pc[:, 1] < r[4]))
        return pc[keep]

    def _process_points(self, pc: np.ndarray) -> np.ndarray:
        """intensity/255 + hard point cap via shuffle (data_loader.py:313-322)."""
        pc[:, -2] /= 255.0
        if pc.shape[0] > self.max_points:
            perm = np.random.permutation(pc.shape[0])[:self.max_points]
            pc = pc[perm]
        return pc

    @staticmethod
    def _filter_objects_by_num_points(objects: np.ndarray,
                                      points: np.ndarray) -> np.ndarray:
        """Keep boxes with >5 lidar points inside their AABB
        (data_loader.py:129-150 — the reference tests the axis-aligned box
        with a strict num_points > 5)."""
        if objects.shape[0] == 0:
            return objects
        from ..core.boxes import points_in_boxes_mask
        counts = points_in_boxes_mask(points, objects).sum(axis=1)
        return objects[counts > 5]
