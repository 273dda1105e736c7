"""Multimodal frame assembly (host-side).

The port's copy of ``mm_training_tpu/data/frame_loader.py``, its arithmetic
unchanged (the camera re-render goes through the port's own remap,
``data/sensor_models``). Re-design of dataset/src/data_loader.py (class
DataLoader): orchestrates per-frame sensor loading — lidar+radar concat
into 8-feature points, range filtering, camera virtualization to
zero-roll/pitch pinholes, timestamp normalization, annotation -> array
conversion with category mapping, and the >5-lidar-points annotation filter.

Documented deviations:
  * the reference's pc-range filter drops the z test through a numpy
    3-arg ``logical_and(in_x, in_y, in_z)`` misuse (data_loader.py:332-337,
    the third argument is an *out* parameter); we filter x and y only, which
    reproduces the effective reference behavior (z is range-limited at
    voxelization anyway).
  * virtualized front/back cameras carry the *virtual* (zero-roll/pitch)
    extrinsic; the reference re-renders the image but keeps the original
    extrinsic (data_loader.py:164), mis-posing the virtual view by the
    original roll/pitch.
  * with use_cam=False no image files are decoded at all (the reference still
    imreads the front JPG it never uses).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from ..configs import CATEGORY_MAPPING
from ..core.transforms import R_Z_FORWARD_TO_BODY
from .formats import Annotation, CameraParams, object_to_array
from .loaders import CameraFrame, load_camera_data, load_lidar_data, load_radar_data
from .native import concat_filter_native
from .sensor_models import CameraMei, CameraPinhole, CameraPinholeDistorted

__all__ = ['DEFAULT_VIRTUAL_IMAGE_SIZE', 'FrameLoader', 'FrameData']

DEFAULT_VIRTUAL_IMAGE_SIZE = (704, 1280)  # reference network input (conf_aim.py:4-5)


@dataclass
class FrameData:
    """One assembled keyframe (reference DataItem)."""
    path: str
    points: np.ndarray              # [N, F] (F=8 with radar, else 5)
    cameras: List[CameraFrame]      # virtualized when use_cam
    camera_timestamp: float
    objects: np.ndarray             # [K, 10] = box9 + class id


class FrameLoader:
    """Loads and assembles sensor data for a keyframe path."""

    def __init__(self, split: str, pc_range, use_cam=True, use_lidar=True,
                 use_radar=True, look_back=0, look_forward=0,
                 virtualize_fisheyes=False,
                 image_size: Tuple[int, int] = DEFAULT_VIRTUAL_IMAGE_SIZE,
                 defer_processing: bool = False):
        self.split = split
        self.pc_range = pc_range
        self.use_cam = use_cam
        self.use_lidar = use_lidar
        self.use_radar = use_radar
        self.look_back = look_back
        self.look_forward = look_forward
        self.virtualize_fisheyes = virtualize_fisheyes
        self.image_size = image_size  # virtual pinhole target (H, W)
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
        camera_data = load_camera_data(data_folder, frame_id, self.use_cam,
                                       read_fisheyes=self.virtualize_fisheyes)

        if self.use_radar:
            radar = load_radar_data(data_folder, frame_id)
            radar_pts = np.concatenate([radar['B_LRR_C'], radar['F_LRR_C']],
                                       axis=0)
            points = concat_filter_native(lidar, radar_pts, self.pc_range,
                                          camera_data.timestamp)
        else:
            points = self._filter_range(lidar)

        cameras = camera_data.items
        if self.use_cam:
            ref_intrinsic = camera_data.front_camera.camera_params.intrinsic
            cameras = self._virtualize_cameras(cameras, ref_intrinsic)

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

        objects = [object_to_array(o) for o in ann.objects]
        if self.use_cam and not self.use_lidar:
            objects = self._filter_objects_by_fov(
                objects, [c.camera_params.extrinsic for c in cameras])
        rows = []
        for arr, type_name in objects:
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

        return FrameData(path=path, points=points, cameras=cameras,
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

    # -------------------------------------------------------- virtualization
    def _virtualize_cameras(self, cameras: List[CameraFrame],
                            ref_intrinsic: np.ndarray) -> List[CameraFrame]:
        """Front/back -> zero-roll/pitch pinholes at the reference intrinsic;
        fisheyes (when enabled and loaded) -> two yaw+-30deg virtual pinholes
        (data_loader.py:152-191)."""
        out = []
        for cam in cameras:
            if cam.image is None:
                continue
            is_pinhole = 'front' in cam.name or 'back' in cam.name
            if is_pinhole:
                img, intr, extr = self._create_virtual_image(
                    cam.image, cam.camera_params, ref_intrinsic,
                    image_size=self.image_size)
                params = CameraParams(intr, extr, cam.camera_params.dist_coeffs,
                                      'pinhole')
                out.append(CameraFrame(cam.name, img, params))
            elif self.virtualize_fisheyes:
                yaw = self._yaw_of(cam.camera_params)
                for dy in (-30.0, 30.0):
                    img, intr, extr = self._create_virtual_image(
                        cam.image, cam.camera_params, ref_intrinsic,
                        new_yaw=yaw + dy, image_size=self.image_size)
                    params = CameraParams(intr, extr,
                                          cam.camera_params.dist_coeffs,
                                          'pinhole')
                    out.append(CameraFrame(cam.name, img, params))
        return out

    @staticmethod
    def _yaw_of(params: CameraParams) -> float:
        ext = np.linalg.inv(params.extrinsic)
        rot = Rotation.from_matrix(ext[:3, :3])
        rz = Rotation.from_matrix(R_Z_FORWARD_TO_BODY)
        return (rot * rz.inv()).as_euler('XYZ', degrees=True)[2]

    @staticmethod
    def _create_virtual_image(img: np.ndarray, params: CameraParams,
                              new_intrinsic: np.ndarray,
                              new_yaw: Optional[float] = None,
                              image_size: Tuple[int, int] = DEFAULT_VIRTUAL_IMAGE_SIZE):
        """Re-render to a zero-roll/pitch pinhole (data_loader.py:207-240)."""
        ext = np.linalg.inv(params.extrinsic)
        rot = Rotation.from_matrix(ext[:3, :3])
        translation = ext[:3, 3]

        if params.xi is None:
            source = CameraPinholeDistorted(params.intrinsic[:, :3],
                                            params.dist_coeffs, img.shape[:2],
                                            rot.as_matrix(), translation)
        else:
            source = CameraMei(params.intrinsic[:, :3], params.xi,
                               params.dist_coeffs, img.shape[:2],
                               rot.as_matrix(), translation)

        rz = Rotation.from_matrix(R_Z_FORWARD_TO_BODY)
        euler = (rot * rz.inv()).as_euler('XYZ', degrees=True)
        euler[0] = euler[1] = 0.0
        if new_yaw is not None:
            euler[2] = new_yaw
        vrot = Rotation.from_euler('XYZ', euler, degrees=True) * rz

        target = CameraPinhole(new_intrinsic[:, :3], image_size,
                               vrot.as_matrix(), translation)
        out_img = target.remap_from(source, img)

        intr4 = np.eye(4)
        intr4[:3, :3] = target.intrinsic
        return out_img, intr4, target.body_to_cam

    # ------------------------------------------------------------- filters
    @staticmethod
    def _filter_objects_by_fov(objects, extrinsics, fov: float = 60.0):
        """Keep objects inside any camera's frustum cone (cam-only mode,
        data_loader.py:262-280)."""
        coef = np.tan(np.deg2rad(fov / 2.0))
        kept = []
        for arr, tname in objects:
            p = np.array([arr[0], arr[1], arr[2], 1.0])
            for ext in extrinsics:
                c = np.asarray(ext) @ p
                x_fwd, y_lat = c[2], c[0]
                if (-coef * x_fwd < y_lat < coef * x_fwd) and x_fwd > 0.5:
                    kept.append((arr, tname))
                    break
        return kept

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
