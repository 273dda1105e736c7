"""ctypes bindings for the native host point pipeline (``data/csrc/pointpack.cpp``).

The port's copy of ``mm_training_tpu/data/native.py``:

  * concat_filter_native(lidar, radar, pc_range, cam_ts) -> [M, 8]
  * pack_points_native(points, bda, cam_ts, cap, seed)
        -> (out [cap, F], mask [cap], cam_ts_norm)

``csrc/pointpack.cpp`` is built with g++ at first use into the port's
``_build/`` (``ops/build.py::load_host``); a failed build raises. The JAX
package's numpy fallback is not carried over: its subsample draws from
numpy's generator, not the C++ xorshift, so its batches would differ from
the JAX loader's. Deterministic per seed (a uint64, as the JAX package
passes it).
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import numpy as np

from ..ops.build import load_host

__all__ = ['concat_filter_native', 'pack_points_native']

_SRC = os.path.join(os.path.dirname(__file__), 'csrc', 'pointpack.cpp')


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_host(_SRC)
    f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    u8p = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')
    lib.concat_filter.restype = ctypes.c_int
    lib.concat_filter.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int,
        f32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, f32p]
    lib.pack_points.restype = ctypes.c_int
    lib.pack_points.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), f32p, u8p, ctypes.c_int,
        ctypes.c_uint64]
    return lib


def concat_filter_native(lidar: np.ndarray, radar: np.ndarray, pc_range,
                         cam_ts: float) -> np.ndarray:
    """[x,y,z,intensity,ts] lidar + [x,y,z,speed,power] radar ->
    range-filtered [M, 8] rows (radar first, reference order)."""
    lidar = np.ascontiguousarray(lidar, np.float32)
    radar = np.ascontiguousarray(radar, np.float32)
    out = np.empty((lidar.shape[0] + radar.shape[0], 8), np.float32)
    m = _lib().concat_filter(
        lidar, lidar.shape[0], lidar.shape[1] if lidar.size else 5,
        radar, radar.shape[0], radar.shape[1] if radar.size else 5,
        pc_range[0], pc_range[1], pc_range[3], pc_range[4],
        float(cam_ts), out)
    return out[:m]


def pack_points_native(points: np.ndarray, bda: Optional[np.ndarray],
                       cam_ts: float, cap: int, seed: int
                       ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Normalize ts, scale intensity, subsample to cap, rotate xyz by bda,
    pad + mask. Returns (out [cap, F], mask [cap] bool, cam_ts_norm)."""
    pts = np.ascontiguousarray(points, np.float32)
    n, f = pts.shape if pts.size else (0, points.shape[1] if points.ndim == 2 else 8)
    if n > cap and pts is points:
        # the C subsampler Fisher-Yates-swaps rows of its input; don't
        # mutate the caller's array
        pts = pts.copy()
    out = np.empty((cap, f), np.float32)
    mask = np.empty((cap,), np.uint8)
    ts_out = ctypes.c_float(0.0)
    # a reference to the contiguous bda for the duration of the call: its
    # address is passed as a bare pointer
    bda_f32 = (np.ascontiguousarray(bda, np.float32)
               if bda is not None else None)
    bda_arr = bda_f32.ctypes.data if bda_f32 is not None else None
    _lib().pack_points(pts, n, f, bda_arr, float(cam_ts),
                       ctypes.byref(ts_out), out, mask, cap,
                       ctypes.c_uint64(int(seed) & 0xFFFFFFFFFFFFFFFF))
    return out, mask.astype(bool), float(ts_out.value)
