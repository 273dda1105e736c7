"""Where the host data path's time goes, on this machine's CPU.

Writes an aiMotive tree with the port's writer (LAZ frames of
``--ground-points`` ground points and ``--objects`` objects; with
``--images`` also 704 x 1280 front and back JPEGs of the writer's
``image_detail``, and with ``--fisheyes`` the two fisheyes) into a
temporary directory, then prints one JSON line: the host ms a frame of
a whole assembled frame (decode, radar, range filter, the >5-point box
filter; with images also the cameras) and of the LAZ decodes inside it
(timed within the frame's own calls, so never more than the frame), of
the box filter alone and of a whole sample (the frame plus BDA and the native packer;
with images also the image augmentation), one frame at a time; with
``--images`` the frame's camera cost split into the JPEG decode, the
re-render to virtual pinholes and the augmentation, beside its LiDAR part;
and the loader's samples/s at B=4 for each ``--workers`` count (second pass
of an epoch). The config is ``lidar_radar``, ``lidar_cam_radar`` with
``--images`` (``virtualize_fisheyes=True, num_cameras=6`` with
``--fisheyes``). These are host numbers: no device is involved.

    python -m mm_training_tpu_torch.exps.profile_loader [--frames 16] [--workers 1 4 8]
        [--images [--fisheyes]]
"""
from __future__ import annotations

import argparse
import json
import tempfile
from typing import Optional, Sequence

import numpy as np

from ..configs import lidar_cam_radar, lidar_radar
from ..core.boxes import points_in_boxes_mask
from ..data import AiMotiveDataset, FrameLoader, generate_synthetic_dataset, loaders
from ..data.aimotive_dataset import augment_image_np
from ..data.loader_bench import loader_samples_per_s, mean_ms, stage_clock
from ..data.loaders import load_camera_data
from ..training.loader import PrefetchLoader

__all__ = ['main']


def _camera_split(ds: AiMotiveDataset, paths, fisheyes: bool) -> dict:
    """Host ms a frame of the camera work, stage by stage: the JPEG decode
    (with the calibration it reads), the re-render to virtual pinholes (the
    remap tables already cached, as in a run) and the augmentation of the
    sample's cameras; and of the same frame assembled without the cameras
    (its LiDAR and radar part)."""
    cfg, fl = ds.cfg, ds.frame_loader
    lidar_fl = FrameLoader(ds.split, cfg.point_cloud_range, False, cfg.use_lidar, cfg.use_radar,
                           cfg.look_back, cfg.look_forward, defer_processing=True)
    where = [(fl._sequence_dir(p), fl._frame_id(p)) for p in paths]
    cams = [load_camera_data(d, f, True, read_fisheyes=fisheyes) for d, f in where]
    virt = [fl._virtualize_cameras(c.items, c.front_camera.camera_params.intrinsic)
            for c in cams]
    rng = np.random.default_rng(0)
    return {
        'cameras': len(virt[0][:cfg.num_cameras]),
        'jpeg_decode_ms': mean_ms(
            lambda w: load_camera_data(*w, True, read_fisheyes=fisheyes), where),
        'rerender_ms': mean_ms(lambda c: fl._virtualize_cameras(
            c.items, c.front_camera.camera_params.intrinsic), cams),
        'augment_ms': mean_ms(lambda v: [augment_image_np(c.image, rng)
                                         for c in v[:cfg.num_cameras]], virt),
        'lidar_frame_ms': mean_ms(lidar_fl.__getitem__, paths),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--frames', type=int, default=16)
    p.add_argument('--ground-points', type=int, default=100_000)
    p.add_argument('--objects', type=int, default=12)
    p.add_argument('--workers', type=int, nargs='+', default=[1, 4, 8])
    p.add_argument('--seed', type=int, default=40)
    p.add_argument('--images', action='store_true',
                   help='write 704 x 1280 JPEGs and load lidar_cam_radar')
    p.add_argument('--fisheyes', action='store_true',
                   help='with --images: the two fisheyes too, virtualized (6 cameras)')
    p.add_argument('--img-hw', type=int, nargs=2, default=[704, 1280])
    args = p.parse_args(argv)
    if args.fisheyes and not args.images:
        p.error('--fisheyes needs --images')

    with tempfile.TemporaryDirectory() as root:
        generate_synthetic_dataset(root, splits=('train',), frames_per_sequence=args.frames,
                                   n_objects=args.objects, seed=args.seed,
                                   write_images=args.images, fisheyes=args.fisheyes,
                                   img_hw=tuple(args.img_hw), image_detail=True,
                                   n_ground_points=args.ground_points, lidar_format='laz')
        if args.images:
            cfg = lidar_cam_radar(H=args.img_hw[0], W=args.img_hw[1],
                                  **(dict(virtualize_fisheyes=True, num_cameras=6)
                                     if args.fisheyes else {}))
        else:
            cfg = lidar_radar()
        ds = AiMotiveDataset(root, cfg, 'train')
        ds[0]                                         # builds the native libraries
        paths = ds.dataset_index
        frames = [ds.frame_loader[p] for p in paths]
        with stage_clock(loaders, 'read_lidar') as decode_s:
            frame_ms = mean_ms(ds.frame_loader.__getitem__, paths)
        result = {
            'config': 'lidar_cam_radar' if args.images else 'lidar_radar',
            'frames': len(paths),
            'points_a_frame': float(np.mean([len(f.points) for f in frames])),
            'decode_ms': sum(decode_s) * 1e3 / len(paths),
            'frame_ms': frame_ms,
            'box_filter_ms': mean_ms(lambda f: points_in_boxes_mask(
                f.points[f.points[:, 3] == 0.0], f.objects), frames),
            'sample_ms': mean_ms(ds.__getitem__, range(len(ds))),
            'loader_samples_per_s': {},
        }
        if args.images:
            result.update(_camera_split(ds, paths, args.fisheyes))
        for n in args.workers:
            loader = PrefetchLoader(ds, 4, num_workers=n)
            try:                                      # the second pass of an epoch
                result['loader_samples_per_s'][n] = loader_samples_per_s(
                    loader, len(loader), warmup=len(loader))
            finally:
                loader.close()
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
