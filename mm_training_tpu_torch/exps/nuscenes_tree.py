"""A synthetic nuScenes install at nuScenes' own sizes, for the nuScenes
path's drives and tests.

:class:`StandInNuScenes` holds the devkit's tables that
``scripts/gen_info.py::generate_info`` reads (``sample``, ``get`` and
``box_velocity``). :func:`write_nuscenes_tree` fills one with a scene a
split, writes the files its records name and the ``nuscenes_infos_<split>
.pkl`` of ``generate_info`` beside them:

  * six cameras in ``data/nuscenes_dataset.py::_CAMS`` order, yawed 55, 0,
    -55, 110, 180 and -110 degrees, each with a seeded roll and pitch of
    about 1 degree (a raw rig: the general splat, kernel K8); intrinsics
    f = 1266 px, c = (816, 492) at 1600 x 900, like nuScenes' CAM_FRONT,
    scaled with ``img_hw``; JPEGs of photo-like entropy (the aiMotive
    writer's ``image_detail``) by the port's own encoder;
  * a LIDAR_TOP key frame and ``sweeps`` earlier sweeps 0.05 s apart, each
    of ``points`` points of a 32-ring scan (ground returns and obstacles)
    as float32 [x, y, z, intensity, ring] ``.bin`` files in the sensor
    frame (mounted 1.84 m up, yawed -90 degrees as nuScenes' is); each
    record has the ego pose of its own time, the cameras too (the ego
    drives at 10 m/s on a slow curve);
  * ``anns`` annotations a sample over the ten detection classes in turn,
    in the global frame with sizes of the class, velocities for movable
    classes. Their category names end in the detection class's name
    (``vehicle.construction_vehicle``, ``movable_object.traffic_cone``):
    the dataset maps a name to the first class it contains, the JAX
    package's rule, under which nuScenes' own ``vehicle.construction`` and
    ``movable_object.trafficcone`` match no class.

Samples of a scene are 0.5 s apart (key frames at 2 Hz).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
from scipy.spatial.transform import Rotation

from ..data.nuscenes_dataset import _CAMS, NUSC_CLASSES
from ..data.synthetic import _write_image
from ..scripts.gen_info import generate_info

__all__ = ['CAMERA_YAW_DEG', 'StandInNuScenes', 'write_nuscenes_tree']

CAMERA_YAW_DEG = {'CAM_FRONT_LEFT': 55.0, 'CAM_FRONT': 0.0, 'CAM_FRONT_RIGHT': -55.0,
                  'CAM_BACK_LEFT': 110.0, 'CAM_BACK': 180.0, 'CAM_BACK_RIGHT': -110.0}
_GENERAL = {'car': 'vehicle', 'truck': 'vehicle', 'construction_vehicle': 'vehicle',
            'bus': 'vehicle', 'trailer': 'vehicle', 'barrier': 'movable_object',
            'motorcycle': 'vehicle', 'bicycle': 'vehicle', 'pedestrian': 'human',
            'traffic_cone': 'movable_object'}
_WLH = {'car': (1.95, 4.6, 1.73), 'truck': (2.5, 6.9, 2.8),
        'construction_vehicle': (2.8, 6.4, 3.2), 'bus': (2.9, 11.0, 3.5),
        'trailer': (2.9, 12.0, 3.9), 'barrier': (2.5, 0.5, 1.0),
        'motorcycle': (0.77, 2.1, 1.47), 'bicycle': (0.6, 1.7, 1.3),
        'pedestrian': (0.67, 0.73, 1.77), 'traffic_cone': (0.41, 0.41, 1.07)}
_STATIC = ('barrier', 'traffic_cone')
_LIDAR_HEIGHT = 1.84
_RINGS = 32


class StandInNuScenes:
    """The devkit tables ``generate_info`` reads: ``sample`` (a list of
    sample records), ``get(table, token)`` and ``box_velocity(token)``."""

    def __init__(self):
        self.sample: list = []
        self.tables: Dict[str, dict] = {t: {} for t in (
            'scene', 'sample_data', 'ego_pose', 'calibrated_sensor', 'sample_annotation')}
        self.velocity: Dict[str, list] = {}

    def add(self, table: str, record: dict) -> str:
        token = f'{table}-{len(self.tables[table]):06d}'
        self.tables[table][token] = dict(record, token=token)
        return token

    def get(self, table: str, token: str) -> dict:
        return self.tables[table][token]

    def box_velocity(self, token: str) -> np.ndarray:
        return np.asarray(self.velocity[token], np.float64)


def _quat(rot: np.ndarray) -> list:
    """Rotation matrix -> nuScenes' [w, x, y, z]."""
    x, y, z, w = Rotation.from_matrix(rot).as_quat()
    return [float(w), float(x), float(y), float(z)]


def _ego_pose(t: float, origin) -> dict:
    yaw = origin[2] + 0.02 * t
    pos = [origin[0] + 10.0 * t, origin[1] + 0.1 * t * t, 0.0]
    return {'rotation': _quat(Rotation.from_euler('z', yaw).as_matrix()),
            'translation': pos, 'timestamp': int(round(t * 1e6))}


def _scan(rng, n: int) -> np.ndarray:
    """[n, 5] float32 sensor-frame returns of a 32-ring spinning LiDAR:
    downward rings hit the ground (z = -1.84 m) up to 80 m, a third of the
    returns an obstacle nearer than that, upward rings obstacles at 15-60 m."""
    ring = np.arange(n) % _RINGS
    elev = np.deg2rad(np.linspace(-30.67, 10.67, _RINGS))[ring]
    azim = rng.uniform(-np.pi, np.pi, n)
    ground = np.where(elev < 0, _LIDAR_HEIGHT / np.tan(np.maximum(-elev, 1e-3)), np.inf)
    far = rng.uniform(15.0, 60.0, n)
    horiz = np.where(ground < 80.0, ground, far)
    hit = rng.random(n) < 1 / 3
    horiz = np.where(hit, np.maximum(2.5, rng.uniform(0.1, 0.9, n) * np.minimum(horiz, far)),
                     horiz)
    horiz = horiz + rng.normal(0.0, 0.02, n)
    out = np.zeros((n, 5), np.float32)
    out[:, 0] = horiz * np.cos(azim)
    out[:, 1] = horiz * np.sin(azim)
    out[:, 2] = np.where(hit | (elev >= 0), horiz * np.tan(elev), -_LIDAR_HEIGHT)
    out[:, 3] = rng.uniform(0, 255, n)
    out[:, 4] = ring
    return out


def _camera_calibrations(rng, img_hw) -> Dict[str, dict]:
    h, w = img_hw
    s = w / 1600.0
    k = [[1266.0 * s, 0.0, 816.0 * s], [0.0, 1266.0 * s, 492.0 * h / 900.0], [0.0, 0.0, 1.0]]
    optical = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    out = {}
    for cam in _CAMS:
        yaw = np.deg2rad(CAMERA_YAW_DEG[cam])
        roll, pitch = rng.uniform(0.5, 1.5, 2) * rng.choice([-1.0, 1.0], 2)
        rot = Rotation.from_euler('ZYX', [yaw, np.deg2rad(pitch), np.deg2rad(roll)]).as_matrix()
        out[cam] = {'rotation': _quat(rot @ optical), 'camera_intrinsic': k,
                    'translation': [0.5 + 1.0 * np.cos(yaw), 1.0 * np.sin(yaw) * 0.5, 1.55]}
    return out


def write_nuscenes_tree(root: str, splits: Dict[str, int] = None, img_hw=(900, 1600),
                        points: int = 34_720, sweeps: int = 9, anns: int = 40,
                        seed: int = 0) -> Dict[str, object]:
    """Write the tree under ``root`` ({split: samples}, default 8 train and
    4 val samples, one scene each) and ``nuscenes_infos_<split>.pkl`` with
    ``generate_info(nusc, {scene}, max_sweeps=sweeps)``. Returns the info
    paths by split, the stand-in tables and the count of files written."""
    splits = splits or {'train': 8, 'val': 4}
    rng = np.random.default_rng(seed)
    nusc = StandInNuScenes()
    calib = _camera_calibrations(rng, img_hw)
    cam_tokens = {cam: nusc.add('calibrated_sensor', dict(
        calib[cam], sensor_token=cam)) for cam in _CAMS}
    lidar_token = nusc.add('calibrated_sensor', {
        'sensor_token': 'LIDAR_TOP', 'translation': [0.94, 0.0, _LIDAR_HEIGHT],
        'rotation': _quat(Rotation.from_euler('z', -np.pi / 2).as_matrix()),
        'camera_intrinsic': []})
    for sub in ['samples/LIDAR_TOP', 'sweeps/LIDAR_TOP'] + [f'samples/{c}' for c in _CAMS]:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    files = 0
    info_paths = {}

    def lidar_record(t, origin, key, prev):
        nonlocal files
        sub = 'samples' if key else 'sweeps'
        ego = nusc.add('ego_pose', _ego_pose(t, origin))
        name = f'{sub}/LIDAR_TOP/{len(nusc.tables["sample_data"]):06d}.pcd.bin'
        _scan(rng, points).tofile(os.path.join(root, name))
        files += 1
        return nusc.add('sample_data', {
            'filename': name, 'ego_pose_token': ego, 'calibrated_sensor_token': lidar_token,
            'timestamp': nusc.get('ego_pose', ego)['timestamp'], 'prev': prev,
            'is_key_frame': key})

    for si, (split, n) in enumerate(splits.items()):
        origin = (500.0 * si, -200.0 * si, 0.3 * si)
        t_start = 100.0 * si
        scene = nusc.add('scene', {'name': f'scene-{split}'})
        prev_lidar = ''
        for i in range(n):
            t = t_start + 0.5 * i
            for k in range(sweeps, 0, -1):             # oldest first: prev chains back
                prev_lidar = lidar_record(t - 0.05 * k, origin, False, prev_lidar)
            data = {'LIDAR_TOP': lidar_record(t, origin, True, prev_lidar)}
            prev_lidar = data['LIDAR_TOP']
            for ci, cam in enumerate(_CAMS):
                ego = nusc.add('ego_pose', _ego_pose(t + 0.008 * (ci - 2.5), origin))
                name = f'samples/{cam}/{len(nusc.tables["sample_data"]):06d}.jpg'
                _write_image(os.path.join(root, name), rng, tuple(img_hw), detail=True)
                files += 1
                data[cam] = nusc.add('sample_data', {
                    'filename': name, 'ego_pose_token': ego,
                    'calibrated_sensor_token': cam_tokens[cam],
                    'timestamp': nusc.get('ego_pose', ego)['timestamp'], 'prev': '',
                    'is_key_frame': True, 'height': img_hw[0], 'width': img_hw[1]})
            key_pose = nusc.get('ego_pose', nusc.get('sample_data', data['LIDAR_TOP'])[
                'ego_pose_token'])
            ego_rot = Rotation.from_quat(np.roll(key_pose['rotation'], -1))
            tokens = []
            for a in range(anns):
                cls = NUSC_CLASSES[a % len(NUSC_CLASSES)]
                wlh = np.asarray(_WLH[cls]) * rng.uniform(0.9, 1.1, 3)
                local = [rng.uniform(-60.0, 60.0), rng.uniform(-24.0, 24.0), wlh[2] / 2]
                yaw = rng.uniform(-np.pi, np.pi)
                ann = nusc.add('sample_annotation', {
                    'sample_token': f'sample-{split}-{i:04d}',
                    'category_name': f'{_GENERAL[cls]}.{cls}',
                    'translation': (ego_rot.apply(local) + key_pose['translation']).tolist(),
                    'size': wlh.tolist(),
                    'rotation': _quat((ego_rot * Rotation.from_euler('z', yaw)).as_matrix()),
                    'num_lidar_pts': 10, 'num_radar_pts': 0})
                nusc.velocity[ann] = ([0.0, 0.0, 0.0] if cls in _STATIC else
                                      [*rng.normal(0.0, 4.0, 2), 0.0])
                tokens.append(ann)
            nusc.sample.append({'token': f'sample-{split}-{i:04d}',
                                'timestamp': nusc.get('sample_data', data['LIDAR_TOP'])[
                                    'timestamp'],
                                'scene_token': scene, 'data': data, 'anns': tokens})
        infos = generate_info(nusc, {f'scene-{split}'}, max_sweeps=sweeps)
        info_paths[split] = os.path.join(root, f'nuscenes_infos_{split}.pkl')
        with open(info_paths[split], 'wb') as f:
            pickle.dump(infos, f)
        files += 1
    return {'info_paths': info_paths, 'nusc': nusc, 'files': files}
