"""Synthetic aiMotive-format dataset tree writer.

The port's copy of ``mm_training_tpu/data/synthetic.py``, with the same
signature and the same random draws: with the same arguments it writes the
same annotation, calibration, egomotion, radar and lidar files, byte for
byte (the LAZ frames through the port's own codec, ``data/lasio.py``). The
tree has the exact aiMotive directory layout (annotations, lidar frames,
egomotion, calibration, camera JPEGs, radar target JSONs), so the loaders,
training and eval run without a download.

Scenes contain a ground plane plus box-shaped objects with lidar returns on
their faces (so the >5-point annotation filter keeps them). The JPEG
encoder (cv2, else PIL) is imported only when ``write_images`` is on.
"""
from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from . import lasio

__all__ = ['generate_synthetic_dataset']

_TYPES = ['CAR', 'TRUCK', 'MOTORCYCLE', 'PEDESTRIAN']
_SIZES = {  # dx, dy, dz
    'CAR': (4.5, 1.9, 1.6), 'TRUCK': (8.0, 2.5, 3.2),
    'MOTORCYCLE': (2.0, 0.8, 1.4), 'PEDESTRIAN': (0.6, 0.6, 1.8),
}


def _calibration_dict(img_hw=(704, 1280), fisheyes: bool = False) -> dict:
    h, w = img_hw
    f = 0.9 * w
    # body (x fwd, y left, z up) -> optical (z fwd, x right, y down), at yaw
    opt = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float)

    def cam_rt(yaw_deg: float, t):
        c, s = np.cos(np.radians(yaw_deg)), np.sin(np.radians(yaw_deg))
        rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], float)
        rt = np.eye(4)
        rt[:3, :3] = opt @ rz.T
        rt[:3, 3] = t
        return rt

    f_lrr = np.eye(4); f_lrr[:3, 3] = [-2.0, 0, -0.5]
    b_lrr = np.eye(4)
    b_lrr[:3, :3] = np.array([[-1, 0, 0], [0, -1, 0], [0, 0, 1]], float)
    b_lrr[:3, 3] = [2.0, 0, -0.5]
    cali = {
        'F_MIDLONGRANGECAM_CL': {
            'model': 'opencv_pinhole',
            'focal_length_px': [f, f], 'principal_point_px': [w / 2, h / 2],
            'distortion_coeffs': [0.0] * 5,
            'RT_sensor_from_body': cam_rt(0.0, [0.0, 0.1, -1.4]).tolist(),
        },
        'B_MIDRANGECAM_C': {
            'model': 'opencv_pinhole',
            'focal_length_px': [f, f], 'principal_point_px': [w / 2, h / 2],
            'distortion_coeffs': [0.0] * 5,
            'RT_sensor_from_body': cam_rt(180.0, [0.0, -0.1, -1.4]).tolist(),
        },
        'F_LRR_C': {'RT_sensor_from_body': f_lrr.tolist()},
        'B_LRR_C': {'RT_sensor_from_body': b_lrr.tolist()},
    }
    if fisheyes:  # Mei unit-sphere omni cameras looking left/right
        ff = w / 3.0
        for key, yaw, ty in (('M_FISHEYE_L', 90.0, 1.0),
                             ('M_FISHEYE_R', -90.0, -1.0)):
            cali[key] = {
                'model': 'mei', 'xi': 0.9,
                'focal_length_px': [ff, ff],
                'principal_point_px': [w / 2, h / 2],
                'distortion_coeffs': [0.0] * 5,
                'RT_sensor_from_body': cam_rt(yaw, [0.0, ty, -1.0]).tolist(),
            }
    return cali


def _scene_objects(rng: np.random.Generator, n_objects: int, x_range=150.0):
    objs = []
    for _ in range(n_objects):
        t = _TYPES[int(rng.integers(0, len(_TYPES)))]
        dx, dy, dz = _SIZES[t]
        x = float(rng.uniform(-x_range, x_range))
        y = float(rng.uniform(-20, 20))
        z = float(dz / 2 - 0.3)
        yaw = float(rng.uniform(-np.pi, np.pi))
        v = rng.uniform(-8, 8, 2)
        objs.append(dict(type=t, box=(x, y, z, dx, dy, dz, yaw,
                                      float(v[0]), float(v[1]))))
    return objs


def _lidar_for_scene(rng, objs, n_ground=6000, n_per_obj=150):
    pts = []
    gx = rng.uniform(-200, 200, n_ground)
    gy = rng.uniform(-25, 25, n_ground)
    gz = rng.normal(-0.3, 0.02, n_ground)
    pts.append(np.stack([gx, gy, gz], -1))
    for o in objs:
        x, y, z, dx, dy, dz, yaw, *_ = o['box']
        local = rng.uniform(-0.5, 0.5, (n_per_obj, 3)) * [dx, dy, dz]
        face = rng.integers(0, 3, n_per_obj)
        sgn = rng.choice([-0.5, 0.5], n_per_obj)
        for ax in range(3):
            sel = face == ax
            local[sel, ax] = sgn[sel] * [dx, dy, dz][ax]
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        pts.append(local @ rot.T + [x, y, z])
    xyz = np.concatenate(pts).astype(np.float32)
    inten = rng.uniform(0, 255, (len(xyz), 1)).astype(np.float32)
    ts = rng.uniform(0, 0.1, (len(xyz), 1)).astype(np.float32) + 1000.0
    return np.concatenate([xyz, inten, ts], -1)


def _radar_json(rng, objs, forward: bool):
    targets = []
    for o in objs:
        x, y, z = o['box'][:3]
        if (x > 2.0) != forward:
            continue
        # body -> sensor using the written calibrations exactly:
        # F_LRR_C: RT_sensor_from_body = [I | (-2, 0, -0.5)]
        # B_LRR_C: R = diag(-1, -1, 1), t = (2, 0, -0.5)
        # so radar_json_to_pcd's inv(extrinsic) lands back on the object
        sx = x - 2.0 if forward else -x + 2.0
        sy = y if forward else -y
        sz = z - 0.5
        r = float(np.hypot(np.hypot(sx, sy), sz))
        if r < 1.0:
            continue
        targets.append({
            'azimuth': float(np.arctan2(sy, sx)),
            'elevation': float(np.arcsin(np.clip(sz / r, -1, 1))),
            'range': r, 'speed': float(rng.uniform(-10, 10)),
            'rcs': 1.0, 'power': float(rng.uniform(10, 40)), 'noise': 0.1,
        })
    return {'id': 0, 'targets': targets}


def _annotation_json(objs):
    out = []
    for i, o in enumerate(objs):
        x, y, z, dx, dy, dz, yaw, vx, vy = o['box']
        out.append({
            'ActorName': f'{o["type"]} {i:02d}',
            'BoundingBox3D Origin X': x, 'BoundingBox3D Origin Y': y,
            'BoundingBox3D Origin Z': z,
            'BoundingBox3D Extent X': dx, 'BoundingBox3D Extent Y': dy,
            'BoundingBox3D Extent Z': dz,
            'BoundingBox3D Orientation Quat W': float(np.cos(yaw / 2)),
            'BoundingBox3D Orientation Quat X': 0.0,
            'BoundingBox3D Orientation Quat Y': 0.0,
            'BoundingBox3D Orientation Quat Z': float(np.sin(yaw / 2)),
            'ObjectId': i, 'ObjectType': o['type'],
            'Occluded': 0, 'Truncated': 0,
            'Relative Velocity X': vx, 'Relative Velocity Y': vy,
            'Relative Velocity Z': 0.0,
        })
    return {'CapturedObjects': out}


def _write_image(path: str, rng, img_hw=(704, 1280),
                 detail: bool = False):
    try:
        import cv2
    except ImportError:  # pragma: no cover
        cv2 = None
    h, w = img_hw
    img = rng.integers(0, 255, (h // 8, w // 8, 3), dtype=np.uint8)
    if cv2 is not None:
        img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        if detail:
            # full-res noise: real photos carry high-frequency content, and
            # JPEG decode cost scales with entropy — the smooth default
            # compresses to a tiny file that decodes unrealistically fast
            # (loader benchmarks would overstate host throughput ~3x).
            # Amplitude/quality calibrated against the reference repo's
            # bundled real camera JPEGs (0.6-0.9 bpp, 2.4-4.6 ms/MP decode):
            # +-10 @ q85 lands at 2.2 bpp, 4.6 ms/MP — the slow end of real
            noise = rng.integers(-10, 10, (h, w, 3), dtype=np.int16)
            img = np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)
            cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 85])
            return
        cv2.imwrite(path, img)
    else:  # pragma: no cover
        from PIL import Image
        Image.fromarray(np.repeat(np.repeat(img, 8, 0), 8, 1)).save(path)


def generate_synthetic_dataset(root: str, splits=('train', 'val'),
                               odds: Sequence[str] = ('highway',),
                               sequences_per_odd: int = 1,
                               frames_per_sequence: int = 2,
                               n_objects: int = 6,
                               img_hw=(704, 1280),
                               seed: int = 0,
                               write_images: bool = True,
                               fisheyes: bool = False,
                               n_ground_points: int = 6000,
                               image_detail: bool = False,
                               lidar_format: str = 'npy') -> str:
    """Write a synthetic dataset tree under ``root`` and return it. With
    ``fisheyes``, two Mei omni cameras (M_FISHEYE_L/R at yaw +-90) get
    calibrations + images so FrameLoader(virtualize_fisheyes=True) can be
    exercised end-to-end (by the camera data slice of the port).
    ``n_ground_points``/``image_detail`` scale the fixture to production
    host-pipeline cost (~100k-point clouds, high-entropy JPEGs).
    ``lidar_format='laz'`` writes real LASzip-compressed frames through the
    native codec (data/lasio.py) instead of ``.npy`` stand-ins, matching
    the on-disk format of the real dataset (lidar_loader.py:86-91)."""
    if lidar_format not in ('npy', 'laz'):
        raise ValueError(f'lidar_format must be npy or laz, got {lidar_format}')
    rng = np.random.default_rng(seed)
    for split in splits:
        for odd in odds:
            for si in range(sequences_per_odd):
                seq = os.path.join(root, split, odd, f'seq{si:03d}')
                ann_dir = os.path.join(seq, 'dynamic', 'box', '3d_body')
                lid_dir = os.path.join(seq, 'dynamic', 'raw-revolutions')
                cali_dir = os.path.join(seq, 'sensor', 'calibration')
                gnss_dir = os.path.join(seq, 'sensor', 'gnssins')
                cam_front = os.path.join(seq, 'sensor', 'camera', 'F_MIDLONGRANGECAM_CL')
                cam_back = os.path.join(seq, 'sensor', 'camera', 'B_MIDRANGECAM_C')
                radar_f = os.path.join(seq, 'sensor', 'radar', 'F_LRR_C')
                radar_b = os.path.join(seq, 'sensor', 'radar', 'B_LRR_C')
                fish_dirs = {
                    key: os.path.join(seq, 'sensor', 'camera', key)
                    for key in (('M_FISHEYE_L', 'M_FISHEYE_R') if fisheyes
                                else ())}
                for d in (ann_dir, lid_dir, cali_dir, gnss_dir, cam_front,
                          cam_back, radar_f, radar_b, *fish_dirs.values()):
                    os.makedirs(d, exist_ok=True)

                with open(os.path.join(cali_dir, 'calibration.json'), 'w') as f:
                    json.dump(_calibration_dict(img_hw, fisheyes), f)

                egomotion, sync = {}, {}
                for fi in range(1, frames_per_sequence + 1):
                    fid = str(fi).zfill(7)
                    objs = _scene_objects(rng, n_objects)
                    with open(os.path.join(ann_dir, f'frame_{fid}.json'), 'w') as f:
                        json.dump(_annotation_json(objs), f)
                    cloud = _lidar_for_scene(rng, objs,
                                             n_ground=n_ground_points)
                    if lidar_format == 'laz':
                        lasio.write_las(
                            os.path.join(lid_dir, f'frame_{fid}.laz'),
                            cloud.astype(np.float64))
                    else:
                        np.save(os.path.join(lid_dir, f'frame_{fid}.npy'),
                                cloud)
                    ego = np.eye(4)
                    ego[0, 3] = fi * 0.5  # forward motion
                    egomotion[str(fi)] = ego.reshape(-1).tolist()
                    sync[str(fi)] = 1000.0 + fi * 0.05
                    with open(os.path.join(radar_f, f'F_LRR_C_{fid}.json'), 'w') as f:
                        json.dump(_radar_json(rng, objs, True), f)
                    with open(os.path.join(radar_b, f'B_LRR_C_{fid}.json'), 'w') as f:
                        json.dump(_radar_json(rng, objs, False), f)
                    if write_images:
                        _write_image(os.path.join(
                            cam_front, f'F_MIDLONGRANGECAM_CL_{fid}.jpg'),
                            rng, img_hw, image_detail)
                        _write_image(os.path.join(
                            cam_back, f'B_MIDRANGECAM_C_{fid}.jpg'),
                            rng, img_hw, image_detail)
                        for key, d in fish_dirs.items():
                            _write_image(os.path.join(d, f'{key}_{fid}.jpg'),
                                         rng, img_hw, image_detail)

                with open(os.path.join(gnss_dir, 'egomotion.json'), 'w') as f:
                    json.dump(egomotion, f)
                with open(os.path.join(seq, 'sensor', 'camera',
                                       'sync_frame2host.json'), 'w') as f:
                    json.dump(sync, f)
    return root
