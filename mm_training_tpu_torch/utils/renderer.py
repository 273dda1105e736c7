"""Offline visualization renderer, without cv2.

The port of ``mm_training_tpu/utils/renderer.py`` (the re-design of the
reference's dataset/src/renderer.py): the point cloud and 3D boxes drawn
into a BEV raster, 3D box wireframes and points projected into camera
images, and the heatmap and depth panels. Outputs are uint8 BGR images
(cv2's convention), as the JAX renderer's.

The JAX renderer draws through cv2; the port has its own primitives, which
give cv2's pixels (held byte for byte against cv2 in the tests):
  * :func:`draw_line`: ``cv2.line`` at thickness 1, ``LINE_8``, integer
    end points: the segment clipped to the image as ``cv2.clipLine`` clips
    it, then OpenCV's 8-connected ``LineIterator`` walk, left to right;
  * :func:`fill_circle`: ``cv2.circle`` filled (thickness -1), ``LINE_8``,
    OpenCV's midpoint walk filling horizontal spans;
  * :data:`JET`: ``cv2.applyColorMap``'s 256-entry ``COLORMAP_JET`` table.
Where cv2 is absent the JAX renderer draws no boxes and falls back to a
grey colormap; the port draws the same in either case.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ['JET', 'Renderer', 'box_corners_3d', 'clip_line', 'draw_boxes_camera', 'draw_line',
           'draw_points_camera', 'fill_circle', 'line_pixels', 'render_bev',
           'render_depth_panel', 'render_heatmap_panel']

# BGR per class id (car, truck/bus, motorcycle, pedestrian, other)
_CLASS_COLORS = [(80, 220, 60), (0, 165, 255), (255, 80, 80),
                 (60, 60, 230), (200, 200, 200)]
_GT_COLOR = (255, 255, 255)

_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),        # bottom
          (4, 5), (5, 6), (6, 7), (7, 4),        # top
          (0, 4), (1, 5), (2, 6), (3, 7),        # verticals
          (0, 5), (1, 4)]                        # front-face cross


def _jet_table() -> np.ndarray:
    """cv2's COLORMAP_JET as [256, 3] uint8 BGR: the classic jet ramps,
    channel k (B 1, G 2, R 3) ``255 * clip(1.5 - |4 i / 255 - k|, 0, 1)``,
    rounded half to even as OpenCV's saturate_cast rounds. OpenCV builds its
    table from float32 values, and one entry rounds the other way: blue at
    index 159, 1.5 exactly here, lies just below it there and gives 1."""
    i = np.arange(256)
    ramps = [np.round(np.clip(382.5 - np.abs(4 * i - 255 * k), 0, 255)) for k in (1, 2, 3)]
    table = np.stack(ramps, -1).astype(np.uint8)
    table[159, 0] = 1
    return table


JET = _jet_table()


def clip_line(size: Tuple[int, int], p1: Tuple[int, int], p2: Tuple[int, int]):
    """``cv2.clipLine(Rect(0, 0, w, h), p1, p2)`` for ``size`` (w, h):
    (inside, p1, p2) with the end points moved onto the image's border where
    the segment leaves it (Cohen-Sutherland, integer arithmetic with the
    doubles OpenCV truncates)."""
    w, h = size
    if w <= 0 or h <= 0:
        return False, p1, p2
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line_pixels(size: Tuple[int, int], p1: Tuple[int, int], p2: Tuple[int, int]):
    """(xs, ys) int arrays of the pixels ``cv2.line(img, p1, p2, color, 1,
    cv2.LINE_8)`` sets on an image of ``size`` (w, h), in its order: the
    segment clipped (:func:`clip_line`), drawn left to right, one pixel a
    step along the major axis and a minor step where Bresenham's error
    ``dx - 2 dy (i + 1) + 2 dx m_i`` turns negative, i.e. ``m_i =
    ceil((2 dy i - dx) / (2 dx))``."""
    w, h = size
    p1 = (int(p1[0]), int(p1[1]))
    p2 = (int(p2[0]), int(p2[1]))
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        inside, p1, p2 = clip_line(size, p1, p2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:                       # left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    i = np.arange(major + 1, dtype=np.int64)
    m = -((major - 2 * minor * i) // (2 * major)) if major else i * 0
    if vert:
        return x1 + m, y1 + sy * i
    return x1 + i, y1 + sy * m


def draw_line(img: np.ndarray, p1, p2, color) -> None:
    """``cv2.line(img, p1, p2, color, 1, cv2.LINE_8)`` in place; ``p1`` and
    ``p2`` integer (x, y), ``img`` [H, W, C] uint8."""
    xs, ys = line_pixels((img.shape[1], img.shape[0]), p1, p2)
    img[ys, xs] = color


def _circle_spans(radius: int):
    """(dy, half width) of the rows ``cv2.circle(..., radius, color, -1)``
    fills around its centre: OpenCV's midpoint walk (drawing.cpp
    ``Circle``), each step filling rows ``cy +- dy`` over ``cx +- dx`` and
    rows ``cy +- dx`` over ``cx +- dy``."""
    spans = []
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        spans += [(-dy, dx), (dy, dx), (-dx, dy), (dx, dy)]
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return spans


def fill_circle(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)`` (``LINE_8``) in place:
    the filled circle's rows, each clipped to the image."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    for dy, half in _circle_spans(int(radius)):
        y = cy + dy
        x0, x1 = max(cx - half, 0), min(cx + half, w - 1)
        if 0 <= y < h and x0 <= x1:
            img[y, x0:x1 + 1] = color


def box_corners_3d(box: np.ndarray) -> np.ndarray:
    """[x,y,z,dx,dy,dz,yaw,...] (gravity center) -> [8, 3] corners; the
    first 4 are the bottom face, corners 0/1 on the +x (front) face."""
    x, y, z, dx, dy, dz, yaw = box[:7]
    sx, sy = dx / 2.0, dy / 2.0
    local = np.array([[+sx, +sy, -dz / 2], [+sx, -sy, -dz / 2],
                      [-sx, -sy, -dz / 2], [-sx, +sy, -dz / 2],
                      [+sx, +sy, +dz / 2], [+sx, -sy, +dz / 2],
                      [-sx, -sy, +dz / 2], [-sx, +sy, +dz / 2]], np.float64)
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return local @ rot.T + np.array([x, y, z])


def render_bev(points: Optional[np.ndarray],
               gt_boxes: Optional[np.ndarray] = None,
               pred_boxes: Optional[np.ndarray] = None,
               pred_labels: Optional[np.ndarray] = None,
               pc_range: Sequence[float] = (-204.8, -25.6, -5, 204.8, 25.6, 3),
               px_per_m: float = 5.0,
               radar_flag_dim: Optional[int] = 3) -> np.ndarray:
    """Rasterize the scene top-down (x right, y up). LiDAR points grey,
    radar points orange; GT boxes white, predictions class-colored."""
    x0, y0, _, x1, y1, _ = pc_range
    w = int(round((x1 - x0) * px_per_m))
    h = int(round((y1 - y0) * px_per_m))
    img = np.zeros((h, w, 3), np.uint8)

    def to_px(xs, ys):
        u = ((xs - x0) * px_per_m).astype(np.int32)
        v = (h - 1 - (ys - y0) * px_per_m).astype(np.int32)
        return u, v

    if points is not None and len(points):
        pts = np.asarray(points)
        u, v = to_px(pts[:, 0], pts[:, 1])
        ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        is_radar = (pts[:, radar_flag_dim] > 0.5
                    if radar_flag_dim is not None and pts.shape[1] > radar_flag_dim
                    else np.zeros(len(pts), bool))
        img[v[ok & ~is_radar], u[ok & ~is_radar]] = (120, 120, 120)
        img[v[ok & is_radar], u[ok & is_radar]] = (0, 140, 255)

    def draw_box(box, color):
        corners = box_corners_3d(box)[:4, :2]
        u, v = to_px(corners[:, 0], corners[:, 1])
        # cv2.polylines, closed: the edges 3-0, 0-1, 1-2, 2-3
        for a, b in ((3, 0), (0, 1), (1, 2), (2, 3)):
            draw_line(img, (u[a], v[a]), (u[b], v[b]), color)
        # heading tick from center to front-face midpoint
        cx, cy = to_px(np.asarray([box[0]]), np.asarray([box[1]]))
        fx, fy = (u[0] + u[1]) // 2, (v[0] + v[1]) // 2
        draw_line(img, (int(cx[0]), int(cy[0])), (int(fx), int(fy)), color)

    if gt_boxes is not None:
        for b in np.asarray(gt_boxes):
            draw_box(b, _GT_COLOR)
    if pred_boxes is not None:
        labels = (np.asarray(pred_labels) if pred_labels is not None
                  else np.zeros(len(pred_boxes), np.int32))
        for b, l in zip(np.asarray(pred_boxes), labels):
            draw_box(b, _CLASS_COLORS[int(l) % len(_CLASS_COLORS)])
    return img


def draw_boxes_camera(image: np.ndarray, boxes: np.ndarray,
                      extrinsic: np.ndarray, intrinsic: np.ndarray,
                      labels: Optional[np.ndarray] = None,
                      color: Optional[Tuple[int, int, int]] = None) -> np.ndarray:
    """Project 3D wireframes (1-pixel lines) into a camera image.

    extrinsic: [4,4] body->camera; intrinsic: [3,3]/[3,4]/[4,4] pinhole."""
    img = image.copy()
    k = np.asarray(intrinsic, np.float64)[:3, :3]
    h, w = img.shape[:2]
    labels = (np.asarray(labels) if labels is not None
              else np.zeros(len(boxes), np.int32))
    for box, lab in zip(np.asarray(boxes), labels):
        corners = box_corners_3d(box)
        cam = (np.asarray(extrinsic, np.float64)[:3, :3] @ corners.T
               + np.asarray(extrinsic, np.float64)[:3, 3:4])      # [3, 8]
        z = cam[2]
        if np.all(z < 0.5):
            continue
        uvw = k @ cam
        u = uvw[0] / np.maximum(uvw[2], 1e-6)
        v = uvw[1] / np.maximum(uvw[2], 1e-6)
        col = color or _CLASS_COLORS[int(lab) % len(_CLASS_COLORS)]
        for a, b in _EDGES:
            if z[a] < 0.5 or z[b] < 0.5:
                continue
            pa = (int(np.clip(u[a], -4 * w, 4 * w)), int(np.clip(v[a], -4 * h, 4 * h)))
            pb = (int(np.clip(u[b], -4 * w, 4 * w)), int(np.clip(v[b], -4 * h, 4 * h)))
            draw_line(img, pa, pb, col)
    return img


def draw_points_camera(image: np.ndarray, points: np.ndarray,
                       extrinsic: np.ndarray, intrinsic: np.ndarray,
                       max_depth: float = 80.0, radius: int = 1,
                       radar_flag_dim: Optional[int] = 3) -> np.ndarray:
    """Project sensor points into a camera image, colored by depth (near red
    -> far blue); radar returns drawn larger. Parity with the reference
    renderer's lidar/radar camera overlays (renderer.py:452-560)."""
    img = image.copy()
    if points is None or not len(points):
        return img
    pts = np.asarray(points, np.float64)
    cam = (np.asarray(extrinsic, np.float64)[:3, :3] @ pts[:, :3].T
           + np.asarray(extrinsic, np.float64)[:3, 3:4])            # [3, P]
    z = cam[2]
    k = np.asarray(intrinsic, np.float64)[:3, :3]
    uvw = k @ cam
    with np.errstate(invalid='ignore'):
        u = np.nan_to_num(uvw[0] / np.maximum(uvw[2], 1e-6),
                          posinf=-1, neginf=-1).astype(np.int32)
        v = np.nan_to_num(uvw[1] / np.maximum(uvw[2], 1e-6),
                          posinf=-1, neginf=-1).astype(np.int32)
    h, w = img.shape[:2]
    ok = (z > 0.5) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    t = np.clip(z / max_depth, 0.0, 1.0)  # 0 near .. 1 far
    colors = np.stack([255 * t, 64 + 0 * t, 255 * (1 - t)], -1).astype(np.uint8)
    is_radar = (pts[:, radar_flag_dim] > 0.5
                if radar_flag_dim is not None and pts.shape[1] > radar_flag_dim
                else np.zeros(len(pts), bool))
    img[v[ok & ~is_radar], u[ok & ~is_radar]] = colors[ok & ~is_radar]
    for ui, vi, ci in zip(u[ok & is_radar], v[ok & is_radar], colors[ok & is_radar]):
        fill_circle(img, (int(ui), int(vi)), radius + 2, ci)
    return img


def _colormap(x: np.ndarray) -> np.ndarray:
    """[H, W] in [0, 1] -> BGR uint8 through cv2's JET table."""
    g = np.clip(x * 255.0, 0, 255).astype(np.uint8)
    return JET[g]


def render_heatmap_panel(heatmaps: Sequence[np.ndarray]) -> np.ndarray:
    """Per-task class heatmaps [H, W] (already sigmoided) -> one horizontal
    panel (the reference logs these to wandb every 200 steps,
    mm_training_aim.py:491-499)."""
    tiles = [_colormap(np.asarray(hm, np.float32)) for hm in heatmaps]
    hmax = max(t.shape[0] for t in tiles)
    tiles = [np.pad(t, ((0, hmax - t.shape[0]), (0, 2), (0, 0)))
             for t in tiles]
    return np.concatenate(tiles, axis=1)


def render_depth_panel(depth_probs: np.ndarray, d_bound) -> np.ndarray:
    """Depth softmax [fh, fw, D] -> expected-depth image, colormapped."""
    d0, d1, step = d_bound
    d = np.asarray(depth_probs, np.float32)
    bins = d0 + step * np.arange(d.shape[-1], dtype=np.float32)
    exp_depth = (d * bins).sum(-1) / np.maximum(d.sum(-1), 1e-6)
    return _colormap((exp_depth - d0) / max(d1 - d0, 1e-6))


class Renderer:
    """Scene renderer over assembled frames (reference Renderer parity).

    Usage:
        r = Renderer(pc_range)
        bev = r.render_frame_bev(frame, pred_boxes, pred_labels)
        cams = r.render_frame_cameras(frame, pred_boxes, pred_labels)
    where ``frame`` is a data.frame_loader.FrameData.
    """

    def __init__(self, pc_range=(-204.8, -25.6, -5, 204.8, 25.6, 3),
                 px_per_m: float = 5.0):
        self.pc_range = pc_range
        self.px_per_m = px_per_m

    def render_frame_bev(self, frame, pred_boxes=None, pred_labels=None):
        gt = frame.objects[:, :9] if len(frame.objects) else None
        return render_bev(frame.points, gt, pred_boxes, pred_labels,
                          pc_range=self.pc_range, px_per_m=self.px_per_m)

    def render_frame_cameras(self, frame, pred_boxes=None, pred_labels=None,
                             draw_points: bool = True):
        out = []
        for cam in frame.cameras:
            if cam.image is None:
                continue
            img = cam.image
            if draw_points and frame.points is not None and len(frame.points):
                img = draw_points_camera(img, frame.points,
                                         cam.camera_params.extrinsic,
                                         cam.camera_params.intrinsic)
            if len(frame.objects):
                img = draw_boxes_camera(img, frame.objects[:, :9],
                                        cam.camera_params.extrinsic,
                                        cam.camera_params.intrinsic,
                                        color=_GT_COLOR)
            if pred_boxes is not None and len(pred_boxes):
                img = draw_boxes_camera(img, pred_boxes,
                                        cam.camera_params.extrinsic,
                                        cam.camera_params.intrinsic,
                                        labels=pred_labels)
            out.append((cam.name, img))
        return out
