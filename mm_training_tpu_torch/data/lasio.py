"""ctypes bindings for the native LAS/LAZ codec (``data/csrc/lasio.cpp``).

The port's copy of ``mm_training_tpu/data/lasio.py``. The aiMotive dataset
stores lidar as LASzip-compressed ``.laz`` frames; the reference reads them
through laspy (dataset/src/loaders/lidar_loader.py:86-91). This module
decodes them natively:

  * ``read_las(path) -> [N, 5] float64`` (x, y, z, intensity, gps_time)
  * ``write_las(path, pts, scale=..., compress=...)`` — LAS 1.2 point
    format 1, optionally LASzip-compressed (the synthetic tree's writer)
  * ``las_info(path)`` — header summary dict

``csrc/lasio.cpp`` is built with g++ at first use into the port's
``_build/`` (``ops/build.py::load_host``). A failed build raises
RuntimeError; a file the codec cannot decode raises :class:`LasError`
(a RuntimeError), each naming the file. Nothing falls back here; the
loader (``data/loaders.py::read_lidar``) decides what else to read.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

from ..ops.build import load_host

__all__ = ['LasError', 'read_las', 'write_las', 'las_info']

_SRC = os.path.join(os.path.dirname(__file__), 'csrc', 'lasio.cpp')

_ERRORS = {
    -1: 'cannot open or read file',
    -2: 'bad LAS magic or truncated header',
    -3: 'unsupported LAS point data format',
    -4: 'unsupported LASzip variant (need chunked coder-0 v2 '
        'POINT10/GPSTIME11/BYTE items)',
    -5: 'corrupt or truncated point stream / chunk table',
    -6: 'output buffer smaller than the point count',
    -7: 'write failed',
    -8: 'coordinates out of int32 range for the chosen scale',
}


class LasError(RuntimeError):
    """The codec could not read or write a file (the message names it)."""


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_host(_SRC)
    f64p = np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS')
    lib.las_info.restype = ctypes.c_int
    lib.las_info.argtypes = [ctypes.c_char_p, f64p]
    lib.las_read_points.restype = ctypes.c_longlong
    lib.las_read_points.argtypes = [ctypes.c_char_p, f64p, ctypes.c_longlong]
    lib.las_write_points.restype = ctypes.c_longlong
    lib.las_write_points.argtypes = [
        ctypes.c_char_p, f64p, ctypes.c_longlong,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_uint]
    return lib


def _check(rc: int, path: str) -> int:
    if rc < 0:
        raise LasError(f'lasio: {_ERRORS.get(rc, f"error {rc}")} ({path})')
    return rc


def las_info(path: str) -> dict:
    out = np.zeros(11, np.float64)
    _check(_lib().las_info(path.encode(), out), path)
    return {
        'npoints': int(out[0]),
        'point_format': int(out[1]),
        'compressed': bool(out[2]),
        'scale': tuple(out[3:6]),
        'offset': tuple(out[6:9]),
        'has_gps': bool(out[9]),
        'record_length': int(out[10]),
    }


def read_las(path: str) -> np.ndarray:
    """Read a .las/.laz file -> [N, 5] float64 (x, y, z, intensity, gps)."""
    n = int(las_info(path)['npoints'])
    out = np.empty((n, 5), np.float64)
    got = _check(int(_lib().las_read_points(path.encode(), out, n)), path)
    return out[:got]


def write_las(path: str, pts: np.ndarray, scale=(1e-3, 1e-3, 1e-3),
              offset=None, compress: Optional[bool] = None,
              chunk_size: int = 50000) -> int:
    """Write [N, >=3] points (cols x, y, z[, intensity[, gps_time]]) as
    LAS 1.2 point format 1. ``compress`` defaults to the file extension
    (.laz -> True). Coordinates are quantized to the scale grid."""
    pts = np.asarray(pts, np.float64)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError('pts must be [N, >=3]')
    full = np.zeros((pts.shape[0], 5), np.float64)
    full[:, :pts.shape[1]] = pts[:, :5]
    if offset is None:
        # center the data so the i32 grid is used symmetrically
        offset = (np.round(full[:, :3].mean(axis=0))
                  if len(full) else np.zeros(3))
    if compress is None:
        compress = path.endswith('.laz')
    rc = int(_lib().las_write_points(
        path.encode(), np.ascontiguousarray(full), full.shape[0],
        float(scale[0]), float(scale[1]), float(scale[2]),
        float(offset[0]), float(offset[1]), float(offset[2]),
        int(bool(compress)), int(chunk_size)))
    return _check(rc, path)
