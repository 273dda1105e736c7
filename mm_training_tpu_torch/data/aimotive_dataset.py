"""aiMotive dataset: keyframe indexing, augmentation, fixed-shape batching.

The port's copy of ``mm_training_tpu/data/aimotive_dataset.py``, its
arithmetic and randomness unchanged, so its samples equal the JAX package's
byte for byte (the image work through the port's own ``data/image.py``, in
place of cv2). Differences from the reference by design (the JAX
package's):
  * every sample is padded to static shapes (points -> max_points with mask,
    boxes -> max_objs with mask); the reference emits ragged lists.
  * augmentation RNG is deterministic per (seed, epoch, index).
  * the image augs (albumentations HueSaturationValue /
    RandomBrightnessContrast / CoarseDropout, aimotive_dataset.py:53-57) are
    re-implemented with the same default parameter ranges.
  * the 30-retry IO loop (aimotive_dataset.py:106-112, which NameErrors when
    all retries fail) becomes a bounded retry that re-raises the last error.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..configs import Config
from ..core.transforms import bda_transform, sample_bda
from . import image
from .formats import Sequence
from .frame_loader import FrameData, FrameLoader
from .native import pack_points_native

__all__ = ['AiMotiveDataset', 'augment_image_np', 'collate_aim', 'get_frames']


def get_frames(root: str, split: str, look_back=0, look_forward=0,
               eval_odd: str = 'all') -> List[str]:
    """Walk root/split/ODD/sequence trees (aimotive_dataset.py:157-179)."""
    paths = []
    odd_path = os.path.join(root, split)
    for odd in sorted(os.listdir(odd_path)):
        if eval_odd != 'all' and odd != eval_odd:
            continue
        for seq in sorted(os.listdir(os.path.join(odd_path, odd))):
            seq_path = os.path.join(odd_path, odd, seq)
            paths.extend(Sequence(seq_path, look_back, look_forward).get_frames())
    return paths


def augment_image_np(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """HSV jitter + brightness/contrast + coarse dropout, albumentations
    default probabilities/ranges (each p=0.5; hue+-20, sat+-30, val+-20;
    brightness/contrast +-0.15; up to 8 holes of 24x24).

    Every pointwise op is a 256-entry lookup table (identical pixel values
    to the direct int16/float arithmetic, since each is a per-value function
    of a uint8 channel). The RNG draws come in the JAX package's order, its
    cv2 branch included, so the same generator gives the same image."""
    mutated = False  # whether img is already our own copy
    arange = np.arange(256, dtype=np.int32)
    if rng.random() < 0.5:
        hsv = image.bgr_to_hsv(img)
        dh = int(rng.integers(-20, 21))
        ds = int(rng.integers(-30, 31))
        dv = int(rng.integers(-20, 21))
        lut = np.stack([
            (arange + dh) % 180,  # H in [0,179]: mod matches int16 math
            np.clip(arange + ds, 0, 255),
            np.clip(arange + dv, 0, 255)], -1).astype(np.uint8)
        img = image.hsv_to_bgr(image.lut(hsv, lut))
        mutated = True
    if rng.random() < 0.5:
        alpha = 1.0 + rng.uniform(-0.15, 0.15)
        beta = rng.uniform(-0.15, 0.15) * 255.0
        lut = np.clip(arange.astype(np.float32) * alpha + beta,
                      0, 255).astype(np.uint8)
        img = image.lut(img, lut)
        mutated = True
    if rng.random() < 0.5:
        if not mutated:
            img = img.copy()  # dropout writes in place
        h, w = img.shape[:2]
        for _ in range(int(rng.integers(1, 9))):
            hh = int(rng.integers(8, 25))
            ww = int(rng.integers(8, 25))
            y0 = int(rng.integers(0, max(h - hh, 1)))
            x0 = int(rng.integers(0, max(w - ww, 1)))
            img[y0:y0 + hh, x0:x0 + ww] = 0
        mutated = True
    return img if mutated else img.copy()


class AiMotiveDataset:
    """Map-style dataset yielding fixed-shape numpy sample dicts."""

    def __init__(self, root_dir: str, cfg: Config, split: str = 'train',
                 eval_odd: Optional[str] = None, retries: int = 30):
        self.cfg = cfg
        self.split = split
        self.root_dir = root_dir
        self.retries = retries
        odd = eval_odd if eval_odd is not None else (cfg.eval_split or 'all')
        self.dataset_index = get_frames(root_dir, split, cfg.look_back,
                                        cfg.look_forward,
                                        odd if split != 'train' else 'all')
        self.frame_loader = FrameLoader(
            split, cfg.point_cloud_range, cfg.use_cam, cfg.use_lidar,
            cfg.use_radar, cfg.look_back, cfg.look_forward,
            virtualize_fisheyes=cfg.virtualize_fisheyes,
            image_size=cfg.final_dim,
            defer_processing=True)  # fused into the native packer below
        self.epoch = 0

    def __len__(self):
        return len(self.dataset_index)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    # ---------------------------------------------------------------- items
    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        err = None
        for _ in range(self.retries):
            try:
                frame = self.frame_loader[self.dataset_index[index]]
                break
            except Exception as e:  # bounded retry (transient FS errors)
                err = e
        else:
            raise RuntimeError(
                f'failed to load {self.dataset_index[index]}') from err
        return self._to_sample(frame, index)

    def _to_sample(self, frame: FrameData, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        training = self.split == 'train'
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + self.epoch * 97 + index) & 0x7FFFFFFF)

        # ---- BDA augmentation (aimotive_dataset.py:64-103,146-153)
        rot, scale, fdx, fdy = sample_bda(rng, cfg.bda_aug_conf, training)
        boxes, bda_rot = bda_transform(frame.objects, rot, scale, fdx, fdy)
        bda_mat = np.eye(4, dtype=np.float32)
        bda_mat[:3, :3] = bda_rot

        # ---- fused ts-normalize / intensity / subsample / BDA / pad (C++)
        pts, mask, cam_ts = pack_points_native(
            frame.points, bda_rot, frame.camera_timestamp, cfg.max_points,
            seed=(cfg.seed * 1_000_003 + self.epoch * 97 + index) & 0xFFFFFFFF)

        k_cap = cfg.max_objs
        gt_boxes = np.zeros((k_cap, 9), np.float32)
        gt_labels = np.zeros((k_cap,), np.int32)
        gt_mask = np.zeros((k_cap,), bool)
        k = min(boxes.shape[0], k_cap)
        gt_boxes[:k] = boxes[:k, :9]
        gt_labels[:k] = boxes[:k, 9].astype(np.int32)
        gt_mask[:k] = True

        sample: Dict[str, np.ndarray] = {
            'points': pts, 'point_mask': mask,
            'gt_boxes': gt_boxes, 'gt_labels': gt_labels, 'gt_mask': gt_mask,
            'bda_mat': bda_mat,
        }

        # ---- cameras. Images ship uint8 (4x less host->device traffic);
        # the reference's timestamp 4th channel is dropped at normalize and
        # never reaches the model (SURVEY quirk) — carried as 'cam_ts'.
        sample['cam_ts'] = np.float32(cam_ts)
        if cfg.use_cam:
            imgs, s2e, intr, extr = [], [], [], []
            for cam in frame.cameras[:cfg.num_cameras]:
                img = cam.image
                if training:
                    img = augment_image_np(img, rng)
                imgs.append(np.ascontiguousarray(img, np.uint8))
                ext = cam.camera_params.extrinsic.astype(np.float32)
                extr.append(ext)
                s2e.append(np.linalg.inv(ext))
                i4 = np.eye(4, dtype=np.float32)
                i4[:3, :4] = cam.camera_params.intrinsic[:3, :4]
                intr.append(i4)
            sample['imgs'] = np.stack(imgs)[None]          # [S=1, N, H, W, 3]
            sample['sensor2ego'] = np.stack(s2e)[None]
            sample['intrin'] = np.stack(intr)[None]
            sample['extrinsics'] = np.stack(extr)[None]
        else:
            sample['imgs'] = np.zeros((1, 1, 1, 1, 3), np.uint8)
            sample['sensor2ego'] = np.eye(4, dtype=np.float32)[None, None]
            sample['intrin'] = np.eye(4, dtype=np.float32)[None, None]
            sample['extrinsics'] = np.eye(4, dtype=np.float32)[None, None]

        if cfg.use_cam and cfg.depth_gt_root:
            sample['depth_gt'] = self._load_depth_gt(frame.path,
                                                     sample['imgs'].shape[1])

        sample['path'] = frame.path  # host metadata, never copied to the device
        return sample

    def _load_depth_gt(self, frame_path: str, n_images: int) -> np.ndarray:
        """Read the precomputed per-camera min-depth grids of a
        ``depth_gt_root`` mirror tree (``<root>/<frame path relative to the
        data root, without extension>_depth.npy``, [N, H/16, W/16] float32,
        0 = empty), as the JAX package's ``scripts/gen_depth_gt.py`` writes
        them."""
        cfg = self.cfg
        rel = os.path.relpath(frame_path, self.root_dir)
        path = os.path.join(cfg.depth_gt_root,
                            os.path.splitext(rel)[0] + '_depth.npy')
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f'depth_gt_root is set but {path} is missing — write the '
                'grids first (the JAX package\'s scripts/gen_depth_gt.py)')
        grids = np.asarray(np.load(path), np.float32)
        n = cfg.num_cameras
        if grids.shape[0] < n:
            # zero grids would become bin-0 "labels" AND a depth oracle that
            # collapses those cameras' lift — fail loudly instead
            raise ValueError(
                f'{path} holds {grids.shape[0]} camera grids but the config '
                f'uses {n} cameras (num_cameras) — write one grid a camera '
                '(with virtualize_fisheyes=True, the two fisheyes give four)')
        grids = grids[:n]
        if grids.shape[0] != n_images:
            # the JAX trainer fails here on the shapes, far from the cause:
            # num_cameras grids for a frame of fewer cameras
            raise ValueError(
                f'{path}: {grids.shape[0]} depth grids (num_cameras={n}) for a frame of '
                f'{n_images} cameras (virtualize_fisheyes={cfg.virtualize_fisheyes}) — set '
                f'num_cameras={n_images}')
        return grids


def collate_aim(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack fixed-shape samples into one batch dict (replaces the ragged
    collate of aimotive_dataset.py:182-231). 'path' stays a python list."""
    batch = {}
    for key in samples[0]:
        if key == 'path':
            batch['path'] = [s['path'] for s in samples]
        else:
            batch[key] = np.stack([s[key] for s in samples])
    return batch
