"""aiMotive dataset: keyframe indexing, augmentation, fixed-shape batching.

The port's copy of ``mm_training_tpu/data/aimotive_dataset.py`` for the
LiDAR configs, its arithmetic and randomness unchanged, so its samples
equal the JAX package's byte for byte. Differences from the reference by
design (the JAX package's):
  * every sample is padded to static shapes (points -> max_points with mask,
    boxes -> max_objs with mask); the reference emits ragged lists.
  * augmentation RNG is deterministic per (seed, epoch, index).
  * the 30-retry IO loop (aimotive_dataset.py:106-112, which NameErrors when
    all retries fail) becomes a bounded retry that re-raises the last error.
A camera config raises: images, their augmentation (``augment_image_np``)
and ``depth_gt_root`` wait for the camera data slice of the port.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..configs import Config
from ..core.transforms import bda_transform, sample_bda
from .formats import Sequence
from .frame_loader import FrameData, FrameLoader
from .native import pack_points_native

__all__ = ['AiMotiveDataset', 'collate_aim', 'get_frames']


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


class AiMotiveDataset:
    """Map-style dataset yielding fixed-shape numpy sample dicts."""

    def __init__(self, root_dir: str, cfg: Config, split: str = 'train',
                 eval_odd: Optional[str] = None, retries: int = 30):
        self.cfg = cfg
        self.split = split
        self.root_dir = root_dir
        self.retries = retries
        self.frame_loader = FrameLoader(
            split, cfg.point_cloud_range, cfg.use_cam, cfg.use_lidar,
            cfg.use_radar, cfg.look_back, cfg.look_forward,
            defer_processing=True)  # fused into the native packer below
        odd = eval_odd if eval_odd is not None else (cfg.eval_split or 'all')
        self.dataset_index = get_frames(root_dir, split, cfg.look_back,
                                        cfg.look_forward,
                                        odd if split != 'train' else 'all')
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

        return {
            'points': pts, 'point_mask': mask,
            'gt_boxes': gt_boxes, 'gt_labels': gt_labels, 'gt_mask': gt_mask,
            'bda_mat': bda_mat,
            # the camera timestamp, normalised; the camera fields are the
            # JAX package's placeholders of a config without the camera
            'cam_ts': np.float32(cam_ts),
            'imgs': np.zeros((1, 1, 1, 1, 3), np.uint8),
            'sensor2ego': np.eye(4, dtype=np.float32)[None, None],
            'intrin': np.eye(4, dtype=np.float32)[None, None],
            'extrinsics': np.eye(4, dtype=np.float32)[None, None],
            'path': frame.path,  # host metadata, never copied to the device
        }


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
