"""Metrics logging: JSONL + optional TensorBoard and wandb.

The port's copy of ``mm_training_tpu/utils/logging.py`` (``MetricsLogger``,
``NullLogger``), which replaces the reference's Lightning self.log /
WandbLogger-or-TensorBoardLogger wiring (mm_training_aim.py:286-288,587).
It writes the same files: ``metrics.jsonl`` under the run's output path,
and the TensorBoard event files under ``tb/<experiment>`` when tensorboardX
is installed. wandb logs when installed and asked for. The image panels
(``log_image``) are PNGs under ``panels/`` written by the port's own
encoder (:func:`encode_png`, stdlib ``zlib`` and ``struct``) in place of
``cv2.imwrite``; the 3D scenes (``log_scene_3d``) an ASCII ``.ply`` and a
boxes JSON under ``scenes/``, in the JAX package's format.
"""
from __future__ import annotations

import json
import struct
import time
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np

try:
    from tensorboardX import SummaryWriter
except ImportError:  # pragma: no cover
    SummaryWriter = None

try:
    import wandb
except ImportError:  # pragma: no cover
    wandb = None

__all__ = ['MetricsLogger', 'NullLogger', 'encode_png']


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """A PNG of a uint8 image: [H, W, 3] BGR (cv2's order, stored as the
    PNG's RGB, as ``cv2.imwrite`` stores it) or [H, W] grey. 8 bits a
    sample, no interlace, filter 0 on every row, one IDAT chunk."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3
                                                           and img.shape[2] != 3):
        raise ValueError(f'encode_png takes uint8 [H, W] or [H, W, 3], got {img.dtype} '
                         f'{img.shape}')
    h, w = img.shape[:2]
    if img.ndim == 3:
        img, color_type = img[..., ::-1], 2
    else:
        color_type = 0
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    return (b'\x89PNG\r\n\x1a\n'
            + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color_type, 0, 0, 0))
            + _png_chunk(b'IDAT', zlib.compress(raw, 6))
            + _png_chunk(b'IEND', b''))


class NullLogger:
    """A logger that writes nothing (the JAX package's logger of a
    multi-process run's ranks above 0)."""

    def log_step(self, step, metrics):
        pass

    def log_scalar(self, step, name, value):
        pass

    def log_eval(self, step, metrics):
        pass

    def log_image(self, step, name, image):
        pass

    def log_scene_3d(self, step, name, points, gt_boxes=None,
                     pred_boxes=None, pred_labels=None):
        pass

    def close(self):
        pass


class MetricsLogger:
    def __init__(self, out_path, experiment_name: str, log_every: int = 50,
                 use_tensorboard: bool = True, use_wandb: bool = False):
        self.out_path = Path(out_path)
        self.out_path.mkdir(parents=True, exist_ok=True)
        self.log_every = log_every
        self.jsonl = open(self.out_path / 'metrics.jsonl', 'a')
        self.tb = (SummaryWriter(str(self.out_path / 'tb' / experiment_name))
                   if use_tensorboard and SummaryWriter is not None else None)
        self.wandb_run = None
        if use_wandb and wandb is not None:  # pragma: no cover
            self.wandb_run = wandb.init(project='mm_training_exp',
                                        name=experiment_name)
        self._t_last = time.time()
        self._step_last = 0

    def _emit(self, step: int, metrics: Dict[str, float]):
        rec = {'step': step, 'time': time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.jsonl.write(json.dumps(rec) + '\n')
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(k, float(v), step)
        if self.wandb_run is not None:  # pragma: no cover
            self.wandb_run.log(dict(metrics), step=step)

    def log_step(self, step: int, metrics):
        """Log a train step's metrics when ``step`` crosses a multiple of
        ``log_every``. An interval-crossing gate, not a modulo: under K-step
        dispatch the step counter advances by K a call. ``metrics`` may hold
        0-dim tensors on the card: they are read only here."""
        if step // self.log_every <= self._step_last // self.log_every:
            return
        now = time.time()
        sps = (step - self._step_last) / max(now - self._t_last, 1e-9)
        self._t_last, self._step_last = now, step
        m = {k: float(v) for k, v in metrics.items()}
        m['steps_per_sec'] = sps
        self._emit(step, m)

    def log_scalar(self, step: int, name: str, value: float):
        self._emit(step, {name: value})

    def log_eval(self, step: int, metrics: Dict[str, float]):
        self._emit(step, metrics)

    def log_scene_3d(self, step: int, name: str, points: np.ndarray,
                     gt_boxes: Optional[np.ndarray] = None,
                     pred_boxes: Optional[np.ndarray] = None,
                     pred_labels: Optional[np.ndarray] = None):
        """Interactive 3D point-cloud scene with GT/pred boxes — the
        reference's wandb.Object3D artifact (mm_training_aim.py:379-404).
        When a wandb run is live, logs the same lidar/beta payload; always
        also writes an offline equivalent under out_path/scenes/: an ASCII
        .ply of the cloud (intensity-colored, viewable in MeshLab/CloudCompare)
        plus a boxes .json ([x,y,z,dx,dy,dz,yaw] + label).

        Boxes use GRAVITY-center z (the dataset/gt convention and
        renderer.box_corners_3d's); decode outputs are bottom-center and
        must be shifted by +dz/2 before logging (trainer._log_scene_panel
        does)."""
        pts = np.asarray(points, np.float32)
        xyz = pts[:, :3]
        # point layout is [x, y, z, is_radar, speed, power, intensity, ...]
        # (data/loaders.py) — intensity lives at column 6; column 3 is the
        # 0/1 radar flag. Fall back to the flag (radar white, lidar black)
        # only when no intensity column exists.
        inten = (pts[:, 6] if pts.shape[1] > 6
                 else pts[:, 3] if pts.shape[1] > 3
                 else np.zeros(len(pts), np.float32))

        def corners(bx):
            x, y, z, dx, dy, dz, yaw = bx[:7]
            c, s = np.cos(yaw), np.sin(yaw)
            sx = np.asarray([-1, 1, 1, -1, -1, 1, 1, -1]) * dx / 2
            sy = np.asarray([-1, -1, 1, 1, -1, -1, 1, 1]) * dy / 2
            # gravity-center z, matching renderer.box_corners_3d
            sz = np.asarray([-1, -1, -1, -1, 1, 1, 1, 1]) * dz / 2
            return np.stack([x + c * sx - s * sy, y + s * sx + c * sy,
                             z + sz], -1)

        if self.wandb_run is not None:  # pragma: no cover
            boxes = []
            for arr, color, labels in ((gt_boxes, (255, 255, 255), None),
                                       (pred_boxes, (255, 64, 64),
                                        pred_labels)):
                for i, bx in enumerate([] if arr is None else arr):
                    boxes.append({
                        'corners': corners(bx).tolist(), 'color': color,
                        'label': str(int(labels[i])) if labels is not None
                                 else ''})
            i8 = np.clip(inten * 255, 0, 255)
            payload = np.concatenate(
                [xyz, np.stack([i8, i8, i8], -1)], axis=1)
            self.wandb_run.log(
                {name: wandb.Object3D({'type': 'lidar/beta',
                                       'points': payload,
                                       'boxes': np.asarray(boxes)})},
                step=step)
        try:
            scenes = self.out_path / 'scenes'
            scenes.mkdir(parents=True, exist_ok=True)
            base = scenes / f'{name}_{step:07d}'
            with open(f'{base}.ply', 'w') as f:
                f.write('ply\nformat ascii 1.0\n'
                        f'element vertex {len(xyz)}\n'
                        'property float x\nproperty float y\nproperty float z\n'
                        'property uchar red\nproperty uchar green\n'
                        'property uchar blue\nend_header\n')
                i8 = np.clip(inten * 255, 0, 255).astype(np.uint8)
                # vectorized write: a per-point python loop costs seconds
                # for 100k+-point clouds, serialized with training
                rows = np.concatenate(
                    [xyz, np.stack([i8, i8, i8], -1)], axis=1)
                np.savetxt(f, rows, fmt='%.3f %.3f %.3f %d %d %d')
            scene = {
                'gt': [] if gt_boxes is None else
                      np.asarray(gt_boxes)[:, :7].tolist(),
                'pred': [] if pred_boxes is None else
                        np.asarray(pred_boxes)[:, :7].tolist(),
                'pred_labels': [] if pred_labels is None else
                               np.asarray(pred_labels).tolist(),
            }
            with open(f'{base}_boxes.json', 'w') as f:
                json.dump(scene, f)
        except OSError:  # pragma: no cover - best-effort artifact
            pass

    def log_image(self, step: int, name: str, image: np.ndarray):
        """HWC uint8 image panel (the reference logged wandb heatmap/depth
        panels every 200 steps, mm_training_aim.py:270-284,491-499). Also
        written as a PNG under out_path/panels/ (:func:`encode_png`) so runs
        without TB/wandb still get inspectable artifacts."""
        # the renderer produces BGR (cv2 convention, kept for the PNG
        # below); TensorBoard and wandb interpret channels as RGB
        rgb = (image[..., ::-1] if image.ndim == 3 and image.shape[-1] == 3
               else image)
        if self.tb is not None:
            self.tb.add_image(name, rgb.transpose(2, 0, 1), step)
        if self.wandb_run is not None:  # pragma: no cover
            self.wandb_run.log({name: wandb.Image(np.ascontiguousarray(rgb))},
                               step=step)
        try:
            panels = self.out_path / 'panels'
            panels.mkdir(parents=True, exist_ok=True)
            (panels / f'{name}_{step:07d}.png').write_bytes(encode_png(image))
        except OSError:  # pragma: no cover - best-effort artifact
            pass

    def close(self):
        """Flush and close the files (idempotent)."""
        if not self.jsonl.closed:
            self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
            self.tb = None
