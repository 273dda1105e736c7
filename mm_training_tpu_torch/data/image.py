"""ctypes bindings for the port's host image library (``data/csrc/image.cpp``).

The JAX package reads, re-renders, augments and writes camera images with
OpenCV on the host. This module gives the same bytes without OpenCV (the
card's machine promises neither cv2 nor PIL):

  * ``imread(path) -> [H, W, 3] uint8 BGR``: baseline JPEG, byte-equal to
    ``cv2.imread`` (libjpeg-turbo's default decode); a file it cannot decode
    exactly (progressive, arithmetic-coded, 12-bit, lossless, CMYK,
    RGB-coded, a sampling other than 4:4:4 / 4:2:2 / 4:2:0, an EXIF
    orientation cv2 would apply) raises ValueError naming the file and the
    feature.
  * ``imwrite_jpeg(path, img, quality)``: a baseline 4:2:0 encoder with the
    Annex K tables scaled as libjpeg scales them (the synthetic writer's).
  * ``convert_maps`` + ``remap_linear``: ``cv2.convertMaps(..., CV_16SC2)``
    and ``cv2.remap(..., INTER_LINEAR)`` with a zero border.
  * ``bgr_to_hsv`` / ``hsv_to_bgr``: ``cv2.cvtColor`` BGR2HSV / HSV2BGR on
    uint8. HSV2BGR equals OpenCV's vector path on all 2^24 inputs; OpenCV
    computes the last ``width % (4 x its float lanes)`` pixels of a row in a
    scalar path that rounds where the vector path truncates (12,395,370 of
    the 2^24 inputs, 73.9%, come out 1 higher there). The data path's widths
    (1280, and 128 in the tiny configs) are whole vector blocks.
  * ``lut``: ``cv2.LUT``; ``resize_linear``: ``cv2.resize(INTER_LINEAR)``.

``csrc/image.cpp`` is built with g++ at first use into the port's
``_build/`` (``ops/build.py::load_host``); a failed build raises. ctypes
releases the GIL for each call, so the loader's threads decode in parallel.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ..ops.build import load_host

__all__ = ['bgr_to_hsv', 'convert_maps', 'decode_jpeg', 'hsv_to_bgr', 'imread', 'imwrite_jpeg',
           'lut', 'remap_linear', 'resize_linear']

_SRC = os.path.join(os.path.dirname(__file__), 'csrc', 'image.cpp')

_ERRORS = {
    -1: 'not a JPEG file',
    -2: 'corrupt or truncated JPEG',
    -3: 'progressive JPEG (only baseline sequential is decoded)',
    -4: 'arithmetic-coded JPEG (only Huffman is decoded)',
    -5: 'not 8-bit JPEG (12- or 16-bit samples)',
    -6: 'lossless or hierarchical JPEG',
    -7: 'chroma sampling other than 4:4:4, 4:2:2 or 4:2:0',
    -8: 'EXIF orientation other than 1 (cv2.imread would rotate or flip it)',
    -9: 'JPEG with other than 1 or 3 components (CMYK?)',
    -10: 'RGB-coded JPEG (Adobe transform 0 or R,G,B component ids)',
    -11: 'image size changed between header and decode',
    -12: 'JPEG without a height in its frame header (DNL)',
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_host(_SRC)
    u8p = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')
    f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    i16p = np.ctypeslib.ndpointer(np.int16, flags='C_CONTIGUOUS')
    u16p = np.ctypeslib.ndpointer(np.uint16, flags='C_CONTIGUOUS')
    i32p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    sigs = {
        'jpeg_header': (ctypes.c_int, [ctypes.c_char_p, i64, i32p]),
        'jpeg_decode': (ctypes.c_int, [ctypes.c_char_p, i64, u8p, i32, i32]),
        'jpeg_encode': (i64, [u8p, i32, i32, i32, u8p, i64]),
        'convert_maps': (None, [f32p, f32p, i64, i16p, u16p]),
        'remap_linear_u8': (None, [u8p, i32, i32, i32, i16p, u16p, i32, i32, u8p]),
        'bgr_to_hsv_u8': (None, [u8p, i64, u8p]),
        'hsv_to_bgr_u8': (None, [u8p, i64, u8p]),
        'lut_u8': (None, [u8p, i64, i32, u8p, u8p]),
        'resize_linear_u8': (None, [u8p, i32, i32, i32, u8p, i32, i32]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def _u8(img: np.ndarray, what: str) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f'{what}: uint8 image expected, got {img.dtype}')
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, name: str = '<bytes>') -> np.ndarray:
    """JPEG bytes -> [H, W, 3] uint8 BGR, as ``cv2.imdecode`` gives them.
    Raises ValueError naming ``name`` and the feature it cannot decode."""
    lib = _lib()
    dims = np.zeros(3, np.int32)
    rc = lib.jpeg_header(data, len(data), dims)
    if rc == 0:
        out = np.empty((int(dims[0]), int(dims[1]), 3), np.uint8)
        rc = lib.jpeg_decode(data, len(data), out, int(dims[0]), int(dims[1]))
    if rc:
        raise ValueError(f'{name}: {_ERRORS.get(rc, f"JPEG error {rc}")}')
    return out


def imread(path: str) -> np.ndarray:
    """Read a JPEG file as ``cv2.imread(path)`` does: [H, W, 3] uint8 BGR.
    A missing file raises FileNotFoundError; a file it cannot decode
    exactly raises ValueError naming the file and the feature."""
    with open(path, 'rb') as f:
        data = f.read()
    return decode_jpeg(data, path)


def imwrite_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write a [H, W, 3] uint8 BGR image as a baseline 4:2:0 JPEG."""
    img = _u8(img, 'imwrite_jpeg')
    if img.ndim != 3 or img.shape[2] != 3 or not (0 < img.shape[0] < 65536
                                                    and 0 < img.shape[1] < 65536):
        raise ValueError(f'imwrite_jpeg: [H, W, 3] image expected, got {img.shape}')
    h, w = img.shape[:2]
    cap = 2 * h * w + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = int(_lib().jpeg_encode(img, h, w, int(quality), out, cap))
        if n >= 0:
            break
        cap = -n
    with open(path, 'wb') as f:
        f.write(out[:n].tobytes())


def convert_maps(map_x: np.ndarray, map_y: np.ndarray):
    """``cv2.convertMaps(map_x, map_y, cv2.CV_16SC2)``: (xy int16 [..., 2],
    fxy uint16 [...])."""
    mx = np.ascontiguousarray(map_x, np.float32)
    my = np.ascontiguousarray(map_y, np.float32)
    if mx.shape != my.shape:
        raise ValueError(f'convert_maps: map shapes {mx.shape} and {my.shape} differ')
    xy = np.empty(mx.shape + (2,), np.int16)
    fxy = np.empty(mx.shape, np.uint16)
    _lib().convert_maps(mx, my, mx.size, xy, fxy)
    return xy, fxy


def remap_linear(img: np.ndarray, xy: np.ndarray, fxy: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, xy, fxy, cv2.INTER_LINEAR)`` (border constant 0) on
    a uint8 [H, W] or [H, W, C] image; returns [h, w, C] ([h, w, 1] for a
    2-D image) with the maps' [h, w]."""
    img = _u8(img, 'remap_linear')
    src = img[..., None] if img.ndim == 2 else img
    xy = np.ascontiguousarray(xy, np.int16)
    fxy = np.ascontiguousarray(fxy, np.uint16)
    if xy.shape[-1] != 2 or xy.shape[:-1] != fxy.shape or fxy.ndim != 2:
        raise ValueError(f'remap_linear: maps {xy.shape} and {fxy.shape}')
    h, w = fxy.shape
    out = np.empty((h, w, src.shape[2]), np.uint8)
    _lib().remap_linear_u8(src, src.shape[0], src.shape[1], src.shape[2], xy, fxy, h, w, out)
    return out


def _three_channel(img: np.ndarray, what: str) -> np.ndarray:
    img = _u8(img, what)
    if img.shape[-1] != 3:
        raise ValueError(f'{what}: [..., 3] image expected, got {img.shape}')
    return img


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HSV)`` on uint8 (H in [0, 180))."""
    img = _three_channel(img, 'bgr_to_hsv')
    out = np.empty_like(img)
    _lib().bgr_to_hsv_u8(img, img.size // 3, out)
    return out


def hsv_to_bgr(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2BGR)`` on uint8, as OpenCV's vector
    path computes it (see the module docstring)."""
    img = _three_channel(img, 'hsv_to_bgr')
    out = np.empty_like(img)
    _lib().hsv_to_bgr_u8(img, img.size // 3, out)
    return out


def lut(img: np.ndarray, table: np.ndarray) -> np.ndarray:
    """``cv2.LUT(img, table)``: a [256] table for every channel, or [256, C]
    (also [1, 256, C]) with one table a channel."""
    img = _u8(img, 'lut')
    cn = img.shape[-1] if img.ndim == 3 else 1
    table = np.asarray(table, np.uint8).reshape(256, -1)
    if table.shape[1] == 1:
        table = np.repeat(table, cn, axis=1)
    if table.shape[1] != cn:
        raise ValueError(f'lut: a table of {table.shape[1]} channels for {cn}')
    out = np.empty_like(img)
    _lib().lut_u8(img, img.size // cn, cn, np.ascontiguousarray(table), out)
    return out


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)``
    on a uint8 [H, W, C] image."""
    img = _u8(img, 'resize_linear')
    if img.ndim != 3:
        raise ValueError(f'resize_linear: [H, W, C] image expected, got {img.shape}')
    out = np.empty((height, width, img.shape[2]), np.uint8)
    _lib().resize_linear_u8(img, img.shape[0], img.shape[1], img.shape[2], out, height, width)
    return out
