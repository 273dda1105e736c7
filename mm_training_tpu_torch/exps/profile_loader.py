"""Where the host data path's time goes, on this machine's CPU.

Writes an aiMotive tree with the port's writer (LAZ frames of
``--ground-points`` ground points and ``--objects`` objects, no image) into
a temporary directory, then prints one JSON line: the host ms a frame of
the LAZ decode, of a whole assembled frame (decode, radar, range filter,
the >5-point box filter), of the box filter alone and of a whole sample
(the frame plus BDA and the native packer), one frame at a time; and the
loader's samples/s at B=4 for each ``--workers`` count (second pass of an
epoch). These are host numbers: no device is involved.

    python -m mm_training_tpu_torch.exps.profile_loader [--frames 16] [--workers 1 4 8]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from ..configs import lidar_radar
from ..core.boxes import points_in_boxes_mask
from ..data import AiMotiveDataset, generate_synthetic_dataset
from ..data.loaders import read_lidar
from ..training.loader import PrefetchLoader

__all__ = ['main']


def _ms(fn, items) -> float:
    t0 = time.perf_counter()
    for x in items:
        fn(x)
    return (time.perf_counter() - t0) * 1e3 / len(items)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--frames', type=int, default=16)
    p.add_argument('--ground-points', type=int, default=100_000)
    p.add_argument('--objects', type=int, default=12)
    p.add_argument('--workers', type=int, nargs='+', default=[1, 4, 8])
    p.add_argument('--seed', type=int, default=40)
    args = p.parse_args(argv)

    with tempfile.TemporaryDirectory() as root:
        generate_synthetic_dataset(root, splits=('train',), frames_per_sequence=args.frames,
                                   n_objects=args.objects, seed=args.seed, write_images=False,
                                   n_ground_points=args.ground_points, lidar_format='laz')
        ds = AiMotiveDataset(root, lidar_radar(), 'train')
        ds[0]                                         # builds the native libraries
        paths = ds.dataset_index
        laz = [os.path.join(os.path.dirname(p).replace(os.path.join('box', '3d_body'),
                                                       'raw-revolutions'),
                            os.path.basename(p).replace('.json', '.laz')) for p in paths]
        frames = [ds.frame_loader[p] for p in paths]
        result = {
            'frames': len(paths),
            'points_a_frame': float(np.mean([len(f.points) for f in frames])),
            'decode_ms': _ms(read_lidar, laz),
            'frame_ms': _ms(ds.frame_loader.__getitem__, paths),
            'box_filter_ms': _ms(lambda f: points_in_boxes_mask(
                f.points[f.points[:, 3] == 0.0], f.objects), frames),
            'sample_ms': _ms(ds.__getitem__, range(len(ds))),
            'loader_samples_per_s': {},
        }
        for n in args.workers:
            loader = PrefetchLoader(ds, 4, num_workers=n)
            try:
                list(loader)
                t0 = time.perf_counter()
                count = sum(b['points'].shape[0] for b in loader)
                result['loader_samples_per_s'][n] = count / (time.perf_counter() - t0)
            finally:
                loader.close()
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
