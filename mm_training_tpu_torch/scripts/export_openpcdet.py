"""Export an aiMotive tree to OpenPCDet's custom-dataset layout.

The port of ``mm_training_tpu/scripts/export_openpcdet.py`` (the
reference's dataset/src/scripts/openpcdet_transform.py:22-87): each key
frame's point cloud becomes ``<out>/<split>/points/<idx>.npy`` ([N, 4] x,
y, z, intensity, float32) and its annotations
``<out>/<split>/labels/<idx>.txt``, a line ``x y z dx dy dz yaw category``
an object.

    python -m mm_training_tpu_torch.scripts.export_openpcdet \
        --data-root /data/aimotive --split train --out /data/openpcdet [--use-radar]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..configs import CLASSES


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--data-root', required=True)
    p.add_argument('--split', default='train')
    p.add_argument('--out', required=True)
    p.add_argument('--use-radar', action='store_true')
    args = p.parse_args(argv)

    from ..data.aimotive_dataset import get_frames
    from ..data.frame_loader import FrameLoader

    frames = get_frames(args.data_root, args.split)
    loader = FrameLoader(args.split, pc_range=(-1e9, -1e9, -1e9, 1e9, 1e9, 1e9),
                         use_cam=False, use_lidar=True,
                         use_radar=args.use_radar)
    pts_dir = os.path.join(args.out, args.split, 'points')
    lbl_dir = os.path.join(args.out, args.split, 'labels')
    os.makedirs(pts_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)

    for idx, path in enumerate(frames):
        frame = loader[path]
        pts = frame.points
        # x, y, z, intensity (intensity is feature -2 in the loader layout)
        out_pts = np.concatenate([pts[:, :3], pts[:, -2:-1]], axis=1)
        np.save(os.path.join(pts_dir, f'{idx:06d}.npy'),
                out_pts.astype(np.float32))
        with open(os.path.join(lbl_dir, f'{idx:06d}.txt'), 'w') as f:
            for obj in frame.objects:
                cat = CLASSES[int(obj[9])].replace('/', '_')
                f.write(' '.join(f'{v:.4f}' for v in obj[:7]) + f' {cat}\n')
    print(f'exported {len(frames)} frames to {args.out}/{args.split}')


if __name__ == '__main__':
    main()
