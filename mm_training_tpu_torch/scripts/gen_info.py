"""Write the nuScenes info pickles ``NuscMVDetDataset`` reads.

The port of ``mm_training_tpu/scripts/gen_info.py`` (the reference's
scripts/gen_info.py:8-122): walks a nuScenes install with the
nuscenes-devkit and writes ``nuscenes_infos_<split>.pkl`` for each split:
sample tokens, each camera's and the LiDAR's calibration and ego pose, the
LiDAR sweeps, the annotation boxes and velocities. :func:`generate_info`
takes any object with the devkit's ``sample`` table, ``get`` and
``box_velocity``.

The devkit is imported by :func:`main` only; without it ``main`` raises
SystemExit naming it.

    python -m mm_training_tpu_torch.scripts.gen_info --data-root /data/nuscenes \
        --version v1.0-trainval --out /data/nuscenes [--max-sweeps 9]
"""
from __future__ import annotations

import argparse
import os
import pickle


def generate_info(nusc, scenes, max_sweeps: int = 0):
    infos = []
    for sample in nusc.sample:
        if nusc.get('scene', sample['scene_token'])['name'] not in scenes:
            continue
        info = {
            'sample_token': sample['token'],
            'timestamp': sample['timestamp'],
            'scene_token': sample['scene_token'],
            'cam_infos': {},
            'lidar_infos': {},
            'ann_infos': [],
            'sweeps': [],
        }
        for name, token in sample['data'].items():
            sd = nusc.get('sample_data', token)

            def record(s):
                return {
                    'filename': s['filename'],
                    'ego_pose': nusc.get('ego_pose', s['ego_pose_token']),
                    'calibrated_sensor': nusc.get(
                        'calibrated_sensor', s['calibrated_sensor_token']),
                    'timestamp': s['timestamp'],
                }

            rec = record(sd)
            if name.startswith('CAM'):
                info['cam_infos'][name] = rec
            elif name.startswith('LIDAR'):
                info['lidar_infos'][name] = rec
                # non-key sweeps, newest first (nusc_mv_det_dataset.py:506-535)
                tok = sd['prev']
                while tok and len(info['sweeps']) < max_sweeps:
                    sw = nusc.get('sample_data', tok)
                    info['sweeps'].append(record(sw))
                    tok = sw['prev']
        for ann_token in sample['anns']:
            ann = nusc.get('sample_annotation', ann_token)
            ann = dict(ann)
            ann['velocity'] = nusc.box_velocity(ann_token).tolist()
            info['ann_infos'].append(ann)
        infos.append(info)
    return infos


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--data-root', required=True)
    p.add_argument('--version', default='v1.0-trainval')
    p.add_argument('--out', default=None)
    p.add_argument('--max-sweeps', type=int, default=0,
                   help='non-key lidar sweeps to record per sample')
    args = p.parse_args(argv)

    try:
        from nuscenes import NuScenes
        from nuscenes.utils import splits
    except ImportError as e:  # pragma: no cover
        raise SystemExit(
            'nuscenes-devkit is required for the legacy nuScenes path: '
            'pip install nuscenes-devkit') from e

    nusc = NuScenes(version=args.version, dataroot=args.data_root)
    out = args.out or args.data_root
    if args.version == 'v1.0-trainval':
        split_map = {'train': splits.train, 'val': splits.val}
    elif args.version == 'v1.0-test':
        split_map = {'test': splits.test}
    else:
        split_map = {'train': splits.mini_train, 'val': splits.mini_val}
    for split, scenes in split_map.items():
        infos = generate_info(nusc, set(scenes), max_sweeps=args.max_sweeps)
        path = os.path.join(out, f'nuscenes_infos_{split}.pkl')
        with open(path, 'wb') as f:
            pickle.dump(infos, f)
        print(f'{path}: {len(infos)} samples')


if __name__ == '__main__':
    main()
