"""The port's ``NuscMVDetDataset`` against the JAX package's.

The six fast cases of ``tests/test_data/test_nuscenes_dataset.py`` on the
same fixture (its images written by the port's encoder, which both
packages read: the JAX package through cv2), each also holding every array
of the port's samples byte-equal to the JAX samples of the same index;
then both packages on a tree of ``exps/nuscenes_tree.py`` (six cameras with
roll and pitch, LiDAR sweeps, all ten classes) in train and eval mode, at
epochs 0 and 1, with CBGS, two camera sweeps and precomputed depth bins.
"""
import os
import pickle

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import mm_training_tpu.configs as jcfg
from mm_training_tpu.data.nuscenes_dataset import NuscMVDetDataset as JDataset
from mm_training_tpu.scripts.gen_depth_gt import main as j_gen_depth_gt
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu_torch.data import NuscMVDetDataset
from mm_training_tpu_torch.data.image import imwrite_jpeg
from mm_training_tpu_torch.exps.nuscenes_tree import write_nuscenes_tree
from mm_training_tpu_torch.scripts.gen_depth_gt import main as gen_depth_gt

CAMS = ('CAM_FRONT', 'CAM_BACK')


def _make_fixture(root, n_samples=3):
    """``tests/test_data/test_nuscenes_dataset.py::_make_fixture``: the same
    infos, LiDAR bins and draws, the random images encoded by the port."""
    rng = np.random.default_rng(0)
    infos = []
    os.makedirs(os.path.join(root, 'samples'), exist_ok=True)
    os.makedirs(os.path.join(root, 'sweeps'), exist_ok=True)
    r_opt = np.asarray([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    for i in range(n_samples):
        cam_infos = {}
        for ci, cam in enumerate(CAMS):
            fname = f'samples/{cam}_{i}.jpg'
            imwrite_jpeg(os.path.join(root, fname), rng.integers(0, 255, (96, 160, 3), np.uint8))
            r = Rotation.from_euler('z', 0.0 if cam == 'CAM_FRONT' else np.pi).as_matrix() @ r_opt
            qx, qy, qz, qw = Rotation.from_matrix(r).as_quat()
            cam_infos[cam] = {
                'filename': fname, 'height': 96, 'width': 160,
                'calibrated_sensor': {
                    'rotation': [qw, qx, qy, qz],
                    'translation': [1.5 * (1 if ci == 0 else -1), 0.0, 1.6],
                    'camera_intrinsic': [[100.0, 0, 80], [0, 100.0, 48], [0, 0, 1]]},
                # captured ~50 ms after the LiDAR key frame: 0.5 m ahead
                'ego_pose': {'rotation': [1, 0, 0, 0], 'translation': [i * 5.0 + 0.5, 0.0, 0.0]},
                'timestamp': 1000 + i,
            }
        anns = [{'category_name': 'vehicle.car' if k % 2 == 0 else 'human.pedestrian.adult',
                 'translation': [i * 5.0 + rng.uniform(5, 30), rng.uniform(-8, 8), 0.8],
                 'size': [1.9, 4.5, 1.6], 'rotation': [1.0, 0, 0, 0],
                 'velocity': [1.0, 0.5, 0.0]} for k in range(4)]
        lidar_cal = {'rotation': [1.0, 0, 0, 0], 'translation': [0, 0, 1.8]}

        def write_bin(fname, pts_sensor):
            raw = np.zeros((len(pts_sensor), 5), np.float32)
            raw[:, :3] = pts_sensor
            raw[:, 3] = rng.uniform(0, 255, len(pts_sensor))
            raw.tofile(os.path.join(root, fname))

        key_pts = np.column_stack([rng.uniform(3, 20, 64), rng.uniform(-8, 8, 64),
                                   rng.uniform(-1.5, 0.5, 64)])
        write_bin(f'samples/LIDAR_TOP_{i}.bin', key_pts)
        # a sweep 0.1 s earlier, 1 m behind: compensated, it lands on the key points
        write_bin(f'sweeps/LIDAR_TOP_{i}.bin', key_pts + [1.0, 0, 0])
        infos.append({
            'sample_token': f'tok{i}', 'timestamp': 1000 + i, 'scene_token': 's0',
            'cam_infos': cam_infos, 'ann_infos': anns,
            'lidar_infos': {'LIDAR_TOP': {
                'filename': f'samples/LIDAR_TOP_{i}.bin', 'calibrated_sensor': lidar_cal,
                'ego_pose': {'rotation': [1, 0, 0, 0], 'translation': [i * 5.0, 0.0, 0.0]},
                'timestamp': (1000 + i) * 1_000_000}},
            'sweeps': [{'filename': f'sweeps/LIDAR_TOP_{i}.bin', 'calibrated_sensor': lidar_cal,
                        'ego_pose': {'rotation': [1, 0, 0, 0],
                                     'translation': [i * 5.0 - 1.0, 0.0, 0.0]},
                        'timestamp': (1000 + i) * 1_000_000 - 100_000}]})
    path = os.path.join(root, 'nuscenes_infos_train.pkl')
    with open(path, 'wb') as f:
        pickle.dump(infos, f)
    return path


def _pair(info_path, root, cfg_kw, cams=CAMS, **kw):
    """(port dataset, JAX dataset) on the same infos and config fields."""
    tc = tcfg.tiny_test_config(**cfg_kw)
    jc = jcfg.tiny_test_config(**cfg_kw)
    return (NuscMVDetDataset(info_path, tc, data_root=root, cams=cams, **kw),
            JDataset(info_path, jc, data_root=root, cams=cams, **kw))


def assert_same_samples(ds, jds, epochs=(0,)):
    """Every index of each epoch: the same keys, each array of the same
    dtype, shape and bytes, the same path."""
    for epoch in epochs:
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        assert len(ds) == len(jds) > 0
        np.testing.assert_array_equal(ds.idx_map, jds.idx_map)
        for i in range(len(ds)):
            got, want = ds[i], jds[i]
            assert sorted(got) == sorted(want)
            assert got.pop('path') == want.pop('path')
            for k, w in want.items():
                g = got[k]
                assert g.dtype == w.dtype and g.shape == w.shape, (k, g.shape, w.shape)
                assert np.ascontiguousarray(g).tobytes() == np.ascontiguousarray(w).tobytes(), \
                    (epoch, i, k)


CAM_ONLY = dict(use_cam=True, use_lidar=False, use_radar=False, H=64, W=128, num_cameras=2)


def test_nuscenes_dataset_items(tmp_path):
    """nuScenes class ids: car 0, pedestrian 8; boxes in the ego frame,
    sizes wlh -> dx (l), dy (w); the same sample again from (seed, epoch,
    index); train mode equal to JAX at epochs 0 and 1."""
    info_path = _make_fixture(str(tmp_path))
    ds, jds = _pair(info_path, str(tmp_path), CAM_ONLY, is_train=True)
    assert len(ds) == 3
    s = ds[0]
    assert s['imgs'].shape == (1, 2, 64, 128, 3) and s['imgs'].dtype == np.uint8
    assert s['intrin'].shape == (1, 2, 4, 4)
    assert s['gt_mask'].sum() == 4
    assert set(s['gt_labels'][s['gt_mask']].tolist()) == {0, 8}
    boxes = s['gt_boxes'][s['gt_mask']]
    assert np.all(np.abs(boxes[:, 0]) < 40)            # train mode: BDA rotation and scale
    assert boxes[0, 3] == pytest.approx(4.5, rel=0.2)
    assert boxes[0, 4] == pytest.approx(1.9, rel=0.2)
    np.testing.assert_array_equal(s['imgs'], ds[0]['imgs'])
    assert_same_samples(ds, jds, epochs=(0, 1))


def test_nuscenes_sensors_share_the_lidar_reference_frame(tmp_path):
    """Camera extrinsics chain through global into the LIDAR ego frame (the
    0.5 m camera-vs-LiDAR ego motion shows in sensor2ego); boxes stay in
    the LiDAR frame."""
    info_path = _make_fixture(str(tmp_path))
    ds, jds = _pair(info_path, str(tmp_path), CAM_ONLY, is_train=False)
    s = ds[0]
    assert s['sensor2ego'][0, 0, 0, 3] == pytest.approx(2.0, abs=1e-6)
    assert s['sensor2ego'][0, 1, 0, 3] == pytest.approx(-1.0, abs=1e-6)
    b = s['gt_boxes'][s['gt_mask']]
    assert np.all(b[:, 0] > 4.0) and np.all(b[:, 0] < 31.0)
    assert_same_samples(ds, jds)


def test_nuscenes_loads_real_lidar_with_sweeps(tmp_path):
    """Points come from the .bin files, the sweep compensated into the key
    frame's ego pose (so the two clouds coincide here)."""
    info_path = _make_fixture(str(tmp_path))
    ds, jds = _pair(info_path, str(tmp_path), CAM_ONLY, is_train=False)
    s = ds[0]
    n = int(s['point_mask'].sum())
    assert n == 128                                     # 64 key + 64 sweep points
    pts = s['points'][s['point_mask']]
    half = np.lexsort(pts[:n // 2, :3].T), np.lexsort(pts[n // 2:, :3].T)
    np.testing.assert_allclose(pts[:n // 2][half[0]][:, :3], pts[n // 2:][half[1]][:, :3],
                               atol=1e-5)
    assert pts[:, 2].min() > -1.5 + 1.7                 # z = sensor z + 1.8
    assert_same_samples(ds, jds)


def test_nuscenes_cbgs_oversamples(tmp_path):
    """CBGS duplicates the pool; its table is drawn again each epoch, the
    same as the JAX package's at epochs 0 and 1."""
    info_path = _make_fixture(str(tmp_path))
    ds, jds = _pair(info_path, str(tmp_path), CAM_ONLY, use_cbgs=True)
    assert len(ds) >= 3
    assert_same_samples(ds, jds, epochs=(0, 1))


def test_nuscenes_eval_mode_center_crop(tmp_path):
    info_path = _make_fixture(str(tmp_path))
    ds, jds = _pair(info_path, str(tmp_path), CAM_ONLY, is_train=False)
    np.testing.assert_allclose(ds[0]['bda_mat'], np.eye(4))   # no augmentation at eval
    assert_same_samples(ds, jds, epochs=(0, 1))


def test_nuscenes_depth_gt_scene_initial_sweep(tmp_path):
    """A scene-initial sample (its missing predecessor repeats the key
    frame as its sweep) emits one depth grid a camera, as a later sample
    does; the port's bins are the JAX tool's bytes."""
    root = str(tmp_path)
    info_path = _make_fixture(root)
    gen_depth_gt(['--dataset', 'nuscenes', '--data-root', root, '--out', root,
                  '--split', 'train', '--workers', '1'])
    j_gen_depth_gt(['--dataset', 'nuscenes', '--data-root', root,
                    '--out', os.path.join(root, 'jax'), '--split', 'train', '--workers', '1'])
    names = sorted(os.listdir(os.path.join(root, 'depth_gt')))
    assert names == sorted(os.listdir(os.path.join(root, 'jax', 'depth_gt')))
    for name in names:
        with open(os.path.join(root, 'depth_gt', name), 'rb') as a, \
                open(os.path.join(root, 'jax', 'depth_gt', name), 'rb') as b:
            assert a.read() == b.read(), name
    ds, jds = _pair(info_path, root, dict(CAM_ONLY, num_sweeps=2, depth_gt_root=root),
                    is_train=False)
    assert ds[0]['depth_gt'].shape == ds[1]['depth_gt'].shape == (2, 4, 8)
    assert_same_samples(ds, jds)


@pytest.fixture(scope='module')
def rig_tree(tmp_path_factory):
    """A small tree of ``write_nuscenes_tree``: 6 cameras of 90 x 160 with
    roll and pitch, 2 LiDAR sweeps of 1500 points, 20 boxes of all ten
    classes a sample; the nuScenes depth bins of both tools."""
    root = str(tmp_path_factory.mktemp('nusc_rig'))
    tree = write_nuscenes_tree(root, splits={'train': 3}, img_hw=(90, 160), points=1500,
                               sweeps=2, anns=20)
    for tool, out in ((gen_depth_gt, root), (j_gen_depth_gt, os.path.join(root, 'jax'))):
        tool(['--dataset', 'nuscenes', '--data-root', root, '--out', out, '--split', 'train',
              '--workers', '1'])
    return root, tree['info_paths']['train']


RIG = dict(use_cam=True, use_lidar=True, use_radar=False, H=64, W=128, num_cameras=6)


@pytest.mark.parametrize('case', ['train', 'eval', 'cbgs', 'sweeps', 'depth_gt', 'radar'])
def test_nuscenes_rig_tree_samples_match_jax(rig_tree, case):
    """Every array of every sample byte-equal to the JAX package's at
    epochs 0 and 1: train mode (resize, crop, flip, BDA), eval mode, CBGS,
    two camera sweeps (the previous key frame), the precomputed depth
    bins, and the 8-feature points of a radar config (intensity, the
    sweep's time lag)."""
    root, info_path = rig_tree
    cfg_kw = dict(RIG)
    kw = dict(cams=tuple(['CAM_FRONT_LEFT', 'CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_BACK_LEFT',
                          'CAM_BACK', 'CAM_BACK_RIGHT']), is_train=case != 'eval')
    if case == 'cbgs':
        kw['use_cbgs'] = True
    elif case == 'sweeps':
        cfg_kw['num_sweeps'] = 2
    elif case == 'depth_gt':
        cfg_kw['depth_gt_root'] = root
    elif case == 'radar':
        cfg_kw['use_radar'] = True
    ds, jds = _pair(info_path, root, cfg_kw, **kw)
    s = ds[1]
    assert s['imgs'].shape[:2] == (cfg_kw.get('num_sweeps', 1), 6)
    assert s['point_mask'].sum() > 1000
    labels = s['gt_labels'][s['gt_mask']]
    assert len(set(labels.tolist())) >= 5
    if case == 'depth_gt':
        assert s['depth_gt'].shape == (6, 4, 8) and (s['depth_gt'] > 0).any()
    assert_same_samples(ds, jds, epochs=(0, 1))
