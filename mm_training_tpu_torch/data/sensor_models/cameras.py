"""Camera model hierarchy (numpy, host-side).

The port's copy of ``mm_training_tpu/data/sensor_models/cameras.py``, its
arithmetic unchanged. Re-design of utils/sensor_models/ (CameraBase/Pinhole/
PinholeDistorted/Mei/Equirect): every model maps pixels <-> 3D rays in its
own z-forward optical frame and can re-render an image taken by another
camera (``remap_from``) through a cached fixed-point remap table — the
mechanism behind the reference's camera virtualization
(dataset/src/data_loader.py:207-240). The table and the bilinear remap are
the port's own (``data/image.py``), byte-equal to the JAX package's
``cv2.convertMaps`` + ``cv2.remap``; the JAX package's nearest-neighbour
branch without cv2 is not carried over.

Conventions (matching the reference):
  * ``rotation``/``translation`` describe the camera pose in the body frame,
    i.e. cam_to_body = [R | t]; ``body_to_cam`` (the dataset "extrinsic") is
    its inverse.
  * ``ray2image`` returns (pixels, invalid_mask); invalid pixels (e.g. points
    behind a pinhole's focal plane) are blacked out after remap.
"""
from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from .. import image

__all__ = ['CameraModel', 'CameraPinhole', 'CameraPinholeDistorted',
           'CameraMei', 'CameraEquirect', 'make_from_json', 'make_from_dict']


class CameraModel:
    model_name = 'base'

    # class-level LRU converter cache, keyed by parameter fingerprints
    # (the reference caches per (target, source) hash, CameraBase.py:186-218).
    # Bounded: each entry holds an [H, W, 2] int16 map + [H, W] uint16
    # fractions (~5.4 MB at production size), and aiMotive calibrations
    # vary per sequence — an unbounded dict would grow by a rig's worth of
    # maps per sequence for the life of the loader process.
    _remap_cache: 'OrderedDict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]]' = OrderedDict()
    _REMAP_CACHE_MAX = 64  # ~0.35 GB worst case; > cameras x in-flight seqs
    # the loader calls remap_from from a ThreadPoolExecutor: every cache
    # read-touch/insert/evict must hold this lock (move_to_end racing a
    # popitem of the same key raises KeyError otherwise)
    _remap_lock = threading.Lock()
    # in-flight compute dedup: concurrent misses on the same (target,
    # source) key wait for the first thread's full-grid ray remap instead
    # of recomputing it (loader warm-up fans many frames of the same rig
    # across the pool at once)
    _remap_inflight: 'dict[Tuple[str, str], threading.Event]' = {}

    def __init__(self, image_size, rotation: Optional[np.ndarray] = None,
                 translation=None):
        """rotation: 3x3 cam->body rotation; translation: cam origin in body."""
        self.image_size = tuple(int(v) for v in image_size)  # (H, W)
        self.cam_to_body = np.eye(4, dtype=np.float64)
        if rotation is not None:
            self.cam_to_body[:3, :3] = np.asarray(rotation, np.float64)
        if translation is not None:
            self.cam_to_body[:3, 3] = np.asarray(translation, np.float64)
        r = self.cam_to_body[:3, :3]
        self.body_to_cam = np.eye(4, dtype=np.float64)
        self.body_to_cam[:3, :3] = r.T
        self.body_to_cam[:3, 3] = -(r.T @ self.cam_to_body[:3, 3])

    # reference-compatible aliases (CameraBase.RT_body_cam / RT_cam_body)
    @property
    def RT_body_cam(self) -> np.ndarray:
        return self.cam_to_body

    @property
    def RT_cam_body(self) -> np.ndarray:
        return self.body_to_cam

    # ------------------------------------------------------------------ api
    def image2ray(self, px: np.ndarray) -> np.ndarray:
        """[..., 2] pixel coords -> [..., 3] rays (unnormalized)."""
        raise NotImplementedError

    def ray2image(self, rays: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[..., 3] rays -> ([..., 2] pixels, [...] invalid mask)."""
        raise NotImplementedError

    def _fingerprint(self) -> str:
        items = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in sorted(self.__dict__.items())}
        return f'{type(self).__name__}:{items}'

    def grid_rays(self) -> np.ndarray:
        """Rays of the full pixel grid, [H, W, 3]."""
        h, w = self.image_size
        xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32), indexing='xy')
        return self.image2ray(np.stack([xs, ys], axis=-1))

    def remap_from(self, source_cam: 'CameraModel', image_in: np.ndarray,
                   use_cache: bool = True) -> np.ndarray:
        """Re-render ``image_in`` (taken by source_cam) as seen by this camera.

        Requires identical camera centers (rotation may differ); the ray
        bundle of this camera's grid is rotated into the source frame and
        projected with the source model (data_loader/create_virtual_image
        pipeline). Returns an image of this camera's size, [H, W, C].
        """
        key = (self._fingerprint(), source_cam._fingerprint())
        cache = CameraModel._remap_cache
        inflight = CameraModel._remap_inflight
        cached = None
        owner = False
        if use_cache:
            while True:
                with CameraModel._remap_lock:
                    cached = cache.get(key)
                    if cached is not None:
                        cache.move_to_end(key)  # LRU touch
                        break
                    waiter = inflight.get(key)
                    if waiter is None:
                        # we compute; peers wait on the event instead of
                        # duplicating the full-grid ray remap
                        inflight[key] = threading.Event()
                        owner = True
                        break
                waiter.wait()
                # loop: re-read the cache — if the owner failed (event set,
                # key absent) we become the next owner and compute ourselves
        if cached is None:
            try:
                rays = self.grid_rays().astype(np.float64)
                if not np.allclose(self.cam_to_body[:3, :3], source_cam.cam_to_body[:3, :3]):
                    assert np.allclose(self.cam_to_body[:3, 3], source_cam.cam_to_body[:3, 3]), \
                        'camera centers must match for pure-rotation remap'
                    rel = source_cam.body_to_cam[:3, :3] @ self.cam_to_body[:3, :3]
                    rays = rays @ rel.T
                px, invalid = source_cam.ray2image(rays.astype(np.float32))
                # bake invalid rays (behind-camera etc.) into the map as
                # far-out-of-range coords: the zero border then fills 0, and
                # the fixed-point maps are converted once, not every call
                mapping = px.astype(np.float32)
                mapping[invalid] = -1e4
                cached = image.convert_maps(mapping[..., 0], mapping[..., 1])
                if use_cache:
                    with CameraModel._remap_lock:
                        cache[key] = cached
                        while len(cache) > CameraModel._REMAP_CACHE_MAX:
                            cache.popitem(last=False)
            finally:
                if owner:
                    with CameraModel._remap_lock:
                        inflight.pop(key, None).set()
        return image.remap_linear(image_in, *cached)

    # --------------------------------------------------------- serialization
    def save_to_dict(self) -> dict:
        d = {'model_name': self.model_name, 'image_size': list(self.image_size),
             'cam_to_body': self.cam_to_body.tolist()}
        return d

    def save_to_json(self, fp: str):
        with open(fp, 'w') as f:
            json.dump(self.save_to_dict(), f)


class CameraPinhole(CameraModel):
    """Undistorted pinhole (utils/sensor_models/CameraPinhole.py)."""
    model_name = 'pinhole'

    def __init__(self, intrinsic, image_size, rotation=None, translation=None):
        super().__init__(image_size, rotation, translation)
        self.intrinsic = np.asarray(intrinsic, np.float64)[:3, :3]

    @staticmethod
    def invert_intrinsic(k: np.ndarray) -> np.ndarray:
        fx, fy, px, py = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
        return np.array([[1 / fx, 0, -px / fx],
                         [0, 1 / fy, -py / fy],
                         [0, 0, 1]], np.float64)

    def image2ray(self, px: np.ndarray) -> np.ndarray:
        h = np.concatenate([px, np.ones_like(px[..., :1])], -1)
        return h @ self.invert_intrinsic(self.intrinsic).T.astype(h.dtype)

    def _project_plane(self, xy: np.ndarray) -> np.ndarray:
        """Normalized image-plane coords -> pixels."""
        h = np.concatenate([xy, np.ones_like(xy[..., :1])], -1)
        out = h @ self.intrinsic.T.astype(h.dtype)
        return out[..., :2]

    def ray2image(self, rays: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        z = rays[..., 2]
        invalid = z <= 0
        zs = np.where(z == 0, 1e-9, z)
        xy = rays[..., :2] / zs[..., None]
        return self._project_plane(xy), invalid

    def save_to_dict(self) -> dict:
        d = super().save_to_dict()
        d['intrinsic'] = self.intrinsic.tolist()
        return d


class CameraPinholeDistorted(CameraPinhole):
    """5-coefficient (k1,k2,p1,p2,k3) radial/tangential pinhole
    (utils/sensor_models/CameraPinholeDistorted.py; 20-iteration undistort)."""
    model_name = 'distorted_pinhole'
    undistort_iterations = 20

    def __init__(self, intrinsic, dist_coeffs, image_size, rotation=None,
                 translation=None):
        super().__init__(intrinsic, image_size, rotation, translation)
        dc = np.asarray(dist_coeffs, np.float64).reshape(-1)
        assert dc.size >= 5, 'need [k1, k2, p1, p2, k3]'
        self.dist_coeffs = dc[:5]

    def _distort(self, xy: np.ndarray) -> np.ndarray:
        k1, k2, p1, p2, k3 = self.dist_coeffs
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + (k1 + (k2 + k3 * r2) * r2) * r2
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
        return np.stack([xd, yd], -1)

    def _undistort(self, xy_d: np.ndarray) -> np.ndarray:
        # OpenCV-style fixed-point iteration (20 rounds, parity with the
        # reference's CameraPinholeDistorted.image2ray): the residual is
        # always taken against the ORIGINAL distorted coordinates
        k1, k2, p1, p2, k3 = self.dist_coeffs
        xd = xy_d[..., 0]
        yd = xy_d[..., 1]
        x, y = xd.copy(), yd.copy()
        for _ in range(self.undistort_iterations):
            xx, yy = x * x, y * y
            r2 = xx + yy
            two_xy = 2.0 * x * y
            radial = 1.0 + (k1 + (k2 + k3 * r2) * r2) * r2
            tx = p1 * two_xy + p2 * (r2 + 2.0 * xx)
            ty = p1 * (r2 + 2.0 * yy) + p2 * two_xy
            x = (xd - tx) / radial
            y = (yd - ty) / radial
        return np.stack([x, y], -1)

    def image2ray(self, px: np.ndarray) -> np.ndarray:
        d = CameraPinhole.image2ray(self, px)
        und = self._undistort(d[..., :2])
        return np.concatenate([und, np.ones_like(und[..., :1])], -1)

    def ray2image(self, rays: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        z = rays[..., 2]
        invalid = z <= 0
        zs = np.where(z == 0, 1e-9, z)
        xy = rays[..., :2] / zs[..., None]
        return self._project_plane(self._distort(xy)), invalid

    def save_to_dict(self) -> dict:
        d = super().save_to_dict()
        d['dist_coeffs'] = self.dist_coeffs.tolist()
        return d


class CameraMei(CameraPinholeDistorted):
    """Mei unit-sphere omnidirectional model with xi
    (utils/sensor_models/CameraMei.py; OpenCV omnidir convention)."""
    model_name = 'mei'

    def __init__(self, intrinsic, xi, dist_coeffs, image_size, rotation=None,
                 translation=None):
        super().__init__(intrinsic, dist_coeffs, image_size, rotation, translation)
        self.xi = float(xi)

    def image2ray(self, px: np.ndarray) -> np.ndarray:
        und = CameraPinholeDistorted.image2ray(self, px)
        x, y = und[..., 0], und[..., 1]
        r2 = x * x + y * y
        a = r2 + 1.0
        b = 2.0 * self.xi * r2
        c = r2 * self.xi * self.xi - 1.0
        zs = (-b + np.sqrt(np.maximum(b * b - 4 * a * c, 0.0))) / (2 * a)
        return np.stack([x * (zs + self.xi), y * (zs + self.xi), zs], -1)

    def ray2image(self, rays: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        norm = np.linalg.norm(rays, axis=-1, keepdims=True)
        norm = np.where(norm == 0, 1e-9, norm)
        s = rays / norm
        z = s[..., 2] + self.xi
        z = np.where(z < 1e-5, np.where(z >= 0, 1e-5, z), z)
        proj = np.stack([s[..., 0], s[..., 1], z], -1)
        return CameraPinholeDistorted.ray2image(self, proj)

    def save_to_dict(self) -> dict:
        d = super().save_to_dict()
        d['xi'] = self.xi
        return d


class CameraEquirect(CameraModel):
    """Equirectangular panorama (utils/sensor_models/CameraEquirect.py).

    Pixels map linearly to (longitude, latitude) over the configured FOV;
    rays use the optical convention (z forward, x right, y down).
    """
    model_name = 'equirect'

    def __init__(self, image_size, lon_range=(-np.pi, np.pi),
                 lat_range=(-np.pi / 2, np.pi / 2), rotation=None,
                 translation=None):
        super().__init__(image_size, rotation, translation)
        self.lon_range = (float(lon_range[0]), float(lon_range[1]))
        self.lat_range = (float(lat_range[0]), float(lat_range[1]))

    def image2ray(self, px: np.ndarray) -> np.ndarray:
        h, w = self.image_size
        lon = self.lon_range[0] + (px[..., 0] / max(w - 1, 1)) * (self.lon_range[1] - self.lon_range[0])
        lat = self.lat_range[0] + (px[..., 1] / max(h - 1, 1)) * (self.lat_range[1] - self.lat_range[0])
        x = np.sin(lon) * np.cos(lat)
        y = np.sin(lat)
        z = np.cos(lon) * np.cos(lat)
        return np.stack([x, y, z], -1)

    def ray2image(self, rays: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        h, w = self.image_size
        n = np.linalg.norm(rays, axis=-1)
        n = np.where(n == 0, 1e-9, n)
        lon = np.arctan2(rays[..., 0], rays[..., 2])
        lat = np.arcsin(np.clip(rays[..., 1] / n, -1.0, 1.0))
        u = (lon - self.lon_range[0]) / (self.lon_range[1] - self.lon_range[0]) * max(w - 1, 1)
        v = (lat - self.lat_range[0]) / (self.lat_range[1] - self.lat_range[0]) * max(h - 1, 1)
        invalid = ((lon < self.lon_range[0]) | (lon > self.lon_range[1])
                   | (lat < self.lat_range[0]) | (lat > self.lat_range[1]))
        return np.stack([u, v], -1), invalid

    def save_to_dict(self) -> dict:
        d = super().save_to_dict()
        d['lon_range'] = list(self.lon_range)
        d['lat_range'] = list(self.lat_range)
        return d


_REGISTRY = {c.model_name: c for c in
             [CameraPinhole, CameraPinholeDistorted, CameraMei, CameraEquirect]}


def make_from_dict(d: dict) -> CameraModel:
    """Factory from a serialized dict (sensor_models/__init__.py:14-25)."""
    name = d['model_name']
    cls = _REGISTRY[name]
    c2b = np.asarray(d.get('cam_to_body', np.eye(4)))
    rot, tr = c2b[:3, :3], c2b[:3, 3]
    size = d['image_size']
    if cls is CameraPinhole:
        return CameraPinhole(np.asarray(d['intrinsic']), size, rot, tr)
    if cls is CameraPinholeDistorted:
        return CameraPinholeDistorted(np.asarray(d['intrinsic']),
                                      np.asarray(d['dist_coeffs']), size, rot, tr)
    if cls is CameraMei:
        return CameraMei(np.asarray(d['intrinsic']), d['xi'],
                         np.asarray(d['dist_coeffs']), size, rot, tr)
    return CameraEquirect(size, d.get('lon_range', (-np.pi, np.pi)),
                          d.get('lat_range', (-np.pi / 2, np.pi / 2)), rot, tr)


def make_from_json(fp: str) -> CameraModel:
    with open(fp) as f:
        return make_from_dict(json.load(f))
