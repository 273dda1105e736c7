"""Precompute depth ground truth from LiDAR, offline.

The port of ``mm_training_tpu/scripts/gen_depth_gt.py`` (the reference's
scripts/gen_depth_gt.py:15-127 writes nuScenes depth bins with a process
pool). Two tree formats, each written byte for byte as the JAX tool
writes it:

* aiMotive (``--dataset aimotive``, the default): for every key frame,
  project the aggregated point cloud into each virtual camera and save the
  min-depth grid of 16 x 16 cells as ``<out>/<frame path>_depth.npy``
  [N, H/16, W/16] float32 (0 where no point lands). Training with
  ``Config.depth_gt_root`` reads them and bins them with K6's
  ``depth_grid_to_onehot`` in place of the on-card projection.
* nuScenes (``--dataset nuscenes``): ``<out>/depth_gt/<image file>.bin``,
  flat float32 (u, v, depth) point lists projected from the key LIDAR_TOP
  frame into each camera (the reference's format, :86-115). Point lists,
  not grids: the nuScenes dataset draws a resize, crop and flip a sample,
  maps the points through it and rasterizes them
  (``data/nuscenes_dataset.py``).

A host tool in numpy: it runs once over a dataset, on any machine, and
needs no card.

    python -m mm_training_tpu_torch.scripts.gen_depth_gt \
        --data-root /data/aimotive --split train --out /data/depth_gt \
        [--workers 8] [--height 704 --width 1280] [--virtualize-fisheyes]
    python -m mm_training_tpu_torch.scripts.gen_depth_gt --dataset nuscenes \
        --data-root /data/nuscenes --split train --out /data/nuscenes
"""
from __future__ import annotations

import argparse
import multiprocessing
import os

import numpy as np


def _pool(workers: int):
    """A pool of fresh interpreters: the caller may hold threads (torch's,
    a loader's), which a forked child would inherit mid-lock."""
    return multiprocessing.get_context('spawn').Pool(workers)


def depth_grid_numpy(points, extrinsic, intrinsic, img_hw, downsample):
    """[H/ds, W/ds] float32 min-depth grid of ``points`` in one camera (0 =
    empty): the projection of ``ops/depth_labels.py`` in float64 numpy,
    with its validity rules (depth > 1 m, strictly inside the border)."""
    h, w = img_hw
    fh, fw = h // downsample, w // downsample
    xyz1 = np.concatenate([points[:, :3], np.ones_like(points[:, :1])], -1)
    cam = xyz1 @ np.asarray(extrinsic, np.float64).T
    depth = cam[:, 2]
    proj = cam @ np.asarray(intrinsic, np.float64).T
    zz = np.where(proj[:, 2] == 0, 1e-9, proj[:, 2])
    u, v = proj[:, 0] / zz, proj[:, 1] / zz
    valid = (depth > 1.0) & (u > 1) & (u < w - 1) & (v > 1) & (v < h - 1)
    grid = np.full((fh, fw), 1e5, np.float32)
    px = (u[valid].astype(np.int64) // downsample)
    py = (v[valid].astype(np.int64) // downsample)
    d = depth[valid].astype(np.float32)
    np.minimum.at(grid, (py, px), d)
    grid[grid >= 1e5] = 0.0
    return grid


def uvd_to_depth_grid(uvd: np.ndarray, img_hw, downsample: int = 16
                      ) -> np.ndarray:
    """(u, v, depth) image points -> [H/ds, W/ds] min-depth grid (0 = empty).
    The validity rules of ``ops/depth_labels.py``: depth > 1 m, strictly
    inside the image border."""
    h, w = img_hw
    fh, fw = h // downsample, w // downsample
    u, v, d = uvd[:, 0], uvd[:, 1], uvd[:, 2]
    valid = (d > 1.0) & (u > 1) & (u < w - 1) & (v > 1) & (v < h - 1)
    grid = np.full((fh, fw), 1e5, np.float32)
    np.minimum.at(grid, (v[valid].astype(np.int64) // downsample,
                         u[valid].astype(np.int64) // downsample),
                  d[valid].astype(np.float32))
    grid[grid >= 1e5] = 0.0
    return grid


def _process_nusc_sample(args):
    """One nuScenes sample -> one (u, v, depth) .bin per key-frame camera
    (the reference's worker, scripts/gen_depth_gt.py:86-115)."""
    info, data_root, out_root = args
    from ..data.nuscenes_dataset import _pose_to_mat, _quat_to_mat

    def sensor_mat(cal):
        m = np.eye(4)
        m[:3, :3] = _quat_to_mat(cal['rotation'])
        m[:3, 3] = cal['translation']
        return m

    li = info.get('lidar_infos', {}).get('LIDAR_TOP')
    if li is None:
        return []
    lpath = os.path.join(data_root, li['filename'])
    if not os.path.isfile(lpath):
        return []
    pts = np.fromfile(lpath, np.float32).reshape(-1, 5)[:, :3]
    lidar_to_global = (_pose_to_mat(li['ego_pose'])
                       @ sensor_mat(li['calibrated_sensor']))
    outs = []
    os.makedirs(os.path.join(out_root, 'depth_gt'), exist_ok=True)
    for cam, rec in info.get('cam_infos', {}).items():
        cal = rec['calibrated_sensor']
        global_to_cam = np.linalg.inv(
            _pose_to_mat(rec['ego_pose']) @ sensor_mat(cal))
        t = global_to_cam @ lidar_to_global
        cam_pts = pts @ t[:3, :3].T + t[:3, 3]
        depth = cam_pts[:, 2]
        k = np.asarray(cal['camera_intrinsic'], np.float64)
        uvw = cam_pts @ k.T
        zz = np.where(np.abs(uvw[:, 2]) < 1e-9, 1e-9, uvw[:, 2])
        u, v = uvw[:, 0] / zz, uvw[:, 1] / zz
        h = rec.get('height', 900)
        w = rec.get('width', 1600)
        valid = (depth > 0.5) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        arr = np.stack([u[valid], v[valid], depth[valid]], -1)
        out = os.path.join(out_root, 'depth_gt',
                           os.path.split(rec['filename'])[-1] + '.bin')
        arr.astype(np.float32).flatten().tofile(out)
        outs.append(out)
    return outs


def main_nuscenes(args):
    import pickle
    info_path = os.path.join(args.data_root,
                             f'nuscenes_infos_{args.split}.pkl')
    with open(info_path, 'rb') as f:
        infos = pickle.load(f)
    work = [(info, args.data_root, args.out) for info in infos]
    if args.workers > 1:
        with _pool(args.workers) as pool:
            outs = pool.map(_process_nusc_sample, work)
    else:
        outs = [_process_nusc_sample(w) for w in work]
    n = sum(len(o) for o in outs)
    skipped = sum(1 for o in outs if not o)
    print(f'wrote {n} depth-GT bins under {os.path.join(args.out, "depth_gt")}')
    if skipped:
        print(f'WARNING: skipped {skipped}/{len(outs)} samples with no '
              'usable LIDAR_TOP file — their cameras get empty depth grids '
              'at train time')


def _process_frame(args):
    path, out_root, data_root, img_hw, downsample, virt_fisheyes = args
    from ..data.frame_loader import FrameLoader
    loader = FrameLoader('val', pc_range=(-1e9, -1e9, -1e9, 1e9, 1e9, 1e9),
                         use_cam=True, use_lidar=True, use_radar=False,
                         virtualize_fisheyes=virt_fisheyes,
                         image_size=img_hw)
    frame = loader[path]
    grids = [depth_grid_numpy(frame.points, c.camera_params.extrinsic,
                              c.camera_params.intrinsic, img_hw, downsample)
             for c in frame.cameras]
    rel = os.path.relpath(path, data_root)
    out = os.path.join(out_root, os.path.splitext(rel)[0] + '_depth.npy')
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.save(out, np.stack(grids) if grids else np.zeros((0,), np.float32))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--data-root', required=True)
    p.add_argument('--split', default='train')
    p.add_argument('--out', required=True)
    p.add_argument('--workers', type=int, default=8)
    p.add_argument('--height', type=int, default=704)
    p.add_argument('--width', type=int, default=1280)
    p.add_argument('--dataset', default='aimotive',
                   choices=['aimotive', 'nuscenes'])
    p.add_argument('--virtualize-fisheyes', action='store_true',
                   help='include the 4 fisheye-derived virtual cameras '
                        '(match Config.virtualize_fisheyes)')
    args = p.parse_args(argv)
    if args.dataset == 'nuscenes':
        return main_nuscenes(args)

    from ..data.aimotive_dataset import get_frames
    frames = get_frames(args.data_root, args.split)
    work = [(f, args.out, args.data_root, (args.height, args.width), 16,
             args.virtualize_fisheyes)
            for f in frames]
    if args.workers > 1:
        with _pool(args.workers) as pool:
            outs = pool.map(_process_frame, work)
    else:
        outs = [_process_frame(w) for w in work]
    print(f'wrote {len(outs)} depth-GT files under {args.out}')


if __name__ == '__main__':
    main()
