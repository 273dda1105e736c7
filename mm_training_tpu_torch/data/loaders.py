"""Per-sensor file loaders (host-side numpy).

The port's copy of ``mm_training_tpu/data/loaders.py``, its arithmetic
unchanged. Re-design of dataset/src/loaders/{camera,lidar,radar}_loader.py:
  * cameras: calibration.json (intrinsics/extrinsics/dist/xi per model) +
    sync_frame2host.json timestamps. The image decode waits for the camera
    data slice of the port: ``load_camera_data`` reads no image, and raises
    when asked for one (``use_cam=True``).
  * lidar: per-frame point files with temporal aggregation via
    egomotion.json pose compensation and an ego-car box filter. LAZ/LAS go
    through the port's native codec (``data/lasio.py``); ``.npy``/``.bin``
    files with columns [x, y, z, intensity, gps_time] are read directly.
  * radar: front/back LRR target-list JSONs, polar -> Cartesian, sensor ->
    body via the inverse extrinsic, output [x, y, z, speed, power].

One difference from the JAX package's reader: a ``.laz``/``.las`` frame the
native codec cannot decode falls back to laspy when it is installed, else to
a same-named ``.npy`` when there is one (the JAX package raises there
without laspy, ``mm_training_tpu/data/loaders.py:172``).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from . import lasio  # native LAS/LAZ codec
from .formats import CameraParams

try:
    import laspy  # optional
except ImportError:  # pragma: no cover
    laspy = None

__all__ = ['CameraFrame', 'CameraData', 'load_camera_data', 'read_camera_params',
           'load_lidar_data', 'read_lidar', 'filter_ego_car',
           'load_radar_data', 'radar_json_to_pcd', 'read_radar_calibrations']

CAMERA_SLICE = ('camera images are decoded by the camera data slice of the port '
                '(JPEG decode without cv2 or PIL, virtualization); it is not ported yet')

CAMERA_MAPPING = {
    'FrontCenter': 'F_STEREO_L',
    'F_STEREO_L': 'F_STEREO_L',
    'F_MIDLONGRANGECAM_CL': 'F_STEREO_L',
    'B_MIDRANGECAM_C': 'B_MIDRANGECAM_C',
    'M_FISHEYE_L': 'M_FISHEYE_L',
    'M_FISHEYE_R': 'M_FISHEYE_R',
}


# ------------------------------------------------------------------- cameras

@dataclass
class CameraFrame:
    name: str
    image: Optional[np.ndarray]
    camera_params: CameraParams


@dataclass
class CameraData:
    items: List[CameraFrame]
    timestamp: float

    @property
    def front_camera(self) -> CameraFrame:
        return self.items[0]


def _intrinsic_3x4(focal, pp) -> np.ndarray:
    return np.array([[focal[0], 0, pp[0], 0],
                     [0, focal[1], pp[1], 0],
                     [0, 0, 1, 0]], np.float64)


def read_camera_params(cali_dir: str) -> Dict[str, CameraParams]:
    """Parse sensor/calibration/calibration.json (camera_loader.py:143-176)."""
    with open(os.path.join(cali_dir, 'calibration.json')) as f:
        cali = json.load(f)
    out: Dict[str, CameraParams] = {}
    for sensor, params in cali.items():
        if sensor in CAMERA_MAPPING and 'RT_sensor_from_body' in params:
            intr = _intrinsic_3x4(params['focal_length_px'],
                                  params['principal_point_px'])
            extr = np.asarray(params['RT_sensor_from_body'], np.float64)
            dist = np.asarray(params.get('distortion_coeffs', [0.0] * 5), np.float64)
            cp = CameraParams(intr, extr, dist, params['model'])
            if 'FISHEYE' in sensor and params['model'] == 'mei':
                cp.xi = params['xi']
            out[CAMERA_MAPPING[sensor]] = cp
    return out


def load_camera_data(data_folder: str, frame_id: str, use_cam: bool,
                     read_fisheyes: bool = False) -> CameraData:
    """Calibration and the host timestamp of the front + back cameras (and
    the fisheyes the calibration defines) with no image (camera_loader.py:
    92-121): the ``use_cam=False`` branch of the JAX package's loader.
    ``use_cam=True`` raises: the image decode is not ported yet."""
    if use_cam or read_fisheyes:
        raise NotImplementedError(CAMERA_SLICE)
    cam_base = os.path.join(data_folder, 'sensor', 'camera')
    fronts = sorted(c for c in os.listdir(cam_base)
                    if c and c[0] == 'F' and c[-1] == 'L')
    if not fronts:
        raise FileNotFoundError(
            f'no front camera directory (F...L) under {cam_base}')

    with open(os.path.join(cam_base, 'sync_frame2host.json')) as f:
        timestamp = json.load(f)[str(int(frame_id))]

    params = read_camera_params(os.path.join(data_folder, 'sensor', 'calibration'))
    items = [CameraFrame('front_cam', None, params['F_STEREO_L']),
             CameraFrame('back_cam', None, params['B_MIDRANGECAM_C'])]
    for name, key in (('left_cam', 'M_FISHEYE_L'), ('right_cam', 'M_FISHEYE_R')):
        if key in params:
            items.append(CameraFrame(name, None, params[key]))
    return CameraData(items=items, timestamp=float(timestamp))


# --------------------------------------------------------------------- lidar

def read_lidar(path: str) -> np.ndarray:
    """One frame -> [N, 5] float32 (x, y, z, intensity, gps_time).

    ``.laz``/``.las`` go through the native codec (LAS 1.2-1.4 + LASzip
    chunked v2 items, the format the reference reads via laspy,
    lidar_loader.py:86-91). A frame the codec cannot decode is read by
    laspy when it is installed, else from a same-named ``.npy`` when there
    is one; a missing frame is read from that ``.npy`` (the synthetic
    trees' npy frames). Otherwise it raises, naming the file. A failed
    build of the codec raises too."""
    base, ext = os.path.splitext(path)
    npy = base + '.npy'
    if ext in ('.laz', '.las'):
        if os.path.exists(path):
            try:
                return lasio.read_las(path).astype(np.float32)
            except lasio.LasError:
                if laspy is not None:
                    with laspy.open(path) as fh:
                        las = fh.read()
                        return np.array([las.x, las.y, las.z, las.intensity, las.gps_time],
                                        dtype=np.float32).T
                if not os.path.exists(npy):
                    raise
        elif not os.path.exists(npy):
            raise FileNotFoundError(f'no lidar frame {path} (nor {npy})')
        path, ext = npy, '.npy'
    if ext == '.npy':
        return np.load(path).astype(np.float32)
    if ext == '.bin':
        return np.fromfile(path, np.float32).reshape(-1, 5)
    raise ValueError(f'unknown lidar file type: {path}')


def filter_ego_car(pc: np.ndarray) -> np.ndarray:
    """Drop returns from the ego vehicle body (lidar_loader.py:79-83)."""
    in_x = (pc[:, 0] < 3.8) & (pc[:, 0] > -1.2)
    in_y = (pc[:, 1] < 1.7) & (pc[:, 1] > -1.7)
    return pc[~(in_x & in_y)]


def load_lidar_data(data_folder: str, frame_id: str, look_back: int = 0,
                    look_forward: int = 0) -> np.ndarray:
    """Temporal aggregation with egomotion compensation
    (lidar_loader.py:44-76) -> [N, 5] point cloud in the key frame's body."""
    with open(os.path.join(data_folder, 'sensor', 'gnssins', 'egomotion.json')) as f:
        egomotion = json.load(f)
    rt_main = np.asarray(egomotion[str(int(frame_id))], np.float64).reshape(4, 4)

    frames = []
    for fr in range(int(frame_id) - look_back, int(frame_id) + look_forward + 1):
        path = os.path.join(data_folder, 'dynamic', 'raw-revolutions',
                            f'frame_{str(fr).zfill(7)}.laz')
        rt_cur = np.asarray(egomotion[str(fr)], np.float64).reshape(4, 4)
        rt = np.linalg.inv(rt_main) @ rt_cur
        pc = filter_ego_car(read_lidar(path))
        xyz1 = np.concatenate([pc[:, :3], np.ones((len(pc), 1), np.float32)], -1)
        pc[:, :3] = (xyz1 @ rt.T.astype(np.float32))[:, :3]
        frames.append(pc)
    return np.concatenate(frames)


# --------------------------------------------------------------------- radar

def read_radar_calibrations(cali_dir: str) -> Dict[str, np.ndarray]:
    with open(os.path.join(cali_dir, 'calibration.json')) as f:
        cali = json.load(f)
    return {s: np.asarray(v['RT_sensor_from_body'], np.float64)
            for s, v in cali.items() if 'LRR' in s and 'RT_sensor_from_body' in v}


def radar_json_to_pcd(raw: Dict, extrinsic: np.ndarray) -> np.ndarray:
    """Polar targets -> [N, 5] body-frame (x, y, z, speed, power)
    (radar_loader.py:110-144) — vectorized."""
    targets = raw['targets']
    if not targets:
        return np.zeros((0, 5), np.float32)
    az = np.array([t['azimuth'] for t in targets], np.float64)
    el = np.array([t['elevation'] for t in targets], np.float64)
    rng = np.array([t['range'] for t in targets], np.float64)
    spd = np.array([t['speed'] for t in targets], np.float64)
    pwr = np.array([t['power'] for t in targets], np.float64)
    pos = np.stack([rng * np.cos(el) * np.cos(az),
                    rng * np.cos(el) * np.sin(az),
                    rng * np.sin(el),
                    np.ones_like(rng)], axis=0)                  # [4, N]
    body = np.linalg.inv(extrinsic) @ pos
    return np.concatenate([body[:3].T, spd[:, None], pwr[:, None]],
                          axis=1).astype(np.float32)


def load_radar_data(data_folder: str, frame_id: str) -> Dict[str, np.ndarray]:
    """Front + back LRR point clouds (radar_loader.py:87-110)."""
    cali = read_radar_calibrations(os.path.join(data_folder, 'sensor', 'calibration'))
    out = {}
    for key in ('F_LRR_C', 'B_LRR_C'):
        path = os.path.join(data_folder, 'sensor', 'radar', key,
                            f'{key}_{frame_id}.json')
        with open(path) as f:
            raw = json.load(f)
        out[key] = radar_json_to_pcd(raw, cali[key])
    return out
