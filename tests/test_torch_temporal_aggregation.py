"""The port's temporal LiDAR aggregation (``look_back`` / ``look_forward``:
``data/loaders.py::load_lidar_data`` and the dataset's window) against the
JAX package's, as ``tests/test_data/test_temporal_aggregation.py`` holds the
JAX one: a moving, yawing ego observes a static landmark over three frames,
and after the egomotion compensation every copy lands on the key frame's
coordinates; no window is the identity; the dataset's window trims the
frame index and about triples each cloud. The same sequence files go
through both packages' readers, whose clouds are held equal bit for bit,
and the aggregated samples and collated batches of a tree the JAX writer
writes are held byte-equal to the JAX loader's."""
import json
import os

import numpy as np
import pytest

import mm_training_tpu.configs as jcfg
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu.data import AiMotiveDataset as JDataset
from mm_training_tpu.data import collate_aim as j_collate
from mm_training_tpu.data.loaders import load_lidar_data as j_load_lidar_data
from mm_training_tpu.data.synthetic import generate_synthetic_dataset as j_generate
from mm_training_tpu_torch.data import AiMotiveDataset, collate_aim
from mm_training_tpu_torch.data.loaders import load_lidar_data


def _pose(x, yaw):
    """body -> world transform."""
    t = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    t[:2, :2] = [[c, -s], [s, c]]
    t[0, 3] = x
    return t


def _write_sequence(root, poses, landmarks_world):
    """A minimal aiMotive sequence, as the JAX test writes it:
    egomotion.json and one .npy frame a pose, holding the static landmarks
    in that frame's own body coordinates."""
    lid_dir = os.path.join(root, 'dynamic', 'raw-revolutions')
    gnss_dir = os.path.join(root, 'sensor', 'gnssins')
    os.makedirs(lid_dir)
    os.makedirs(gnss_dir)
    ego = {}
    for fi, pose in poses.items():
        ego[str(fi)] = pose.reshape(-1).tolist()
        inv = np.linalg.inv(pose)
        xyz = landmarks_world @ inv[:3, :3].T + inv[:3, 3]
        pc = np.zeros((len(xyz), 5), np.float32)
        pc[:, :3] = xyz
        pc[:, 3] = 100.0
        np.save(os.path.join(lid_dir, f'frame_{str(fi).zfill(7)}.npy'), pc)
    with open(os.path.join(gnss_dir, 'egomotion.json'), 'w') as f:
        json.dump(ego, f)


def _load_both(root, frame_id, **window):
    """The port's aggregated cloud, held bit for bit to the JAX reader's."""
    got = load_lidar_data(root, frame_id, **window)
    want = j_load_lidar_data(root, frame_id, **window)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    return got


def test_static_landmark_lands_on_key_frame(tmp_path):
    """Three frames, the ego moving 2 m and yawing 0.1 rad a frame: all three
    copies of each landmark coincide in the key frame's body coordinates."""
    root = str(tmp_path)
    poses = {1: _pose(0.0, 0.0), 2: _pose(2.0, 0.1), 3: _pose(4.0, 0.2)}
    landmarks = np.asarray([[12.0, 3.0, 0.5], [20.0, -4.0, 1.0], [15.0, 0.0, 2.0]])
    _write_sequence(root, poses, landmarks)

    agg = _load_both(root, '0000002', look_back=1, look_forward=1)
    assert agg.shape == (9, 5)   # 3 frames x 3 landmarks, the ego filter keeps all

    key_pose_inv = np.linalg.inv(poses[2])
    expect = landmarks @ key_pose_inv[:3, :3].T + key_pose_inv[:3, 3]
    got = agg[:, :3].reshape(3, 3, 3)   # [frame, landmark, xyz]
    for fr in range(3):
        np.testing.assert_allclose(got[fr], expect, atol=1e-5,
                                   err_msg=f'frame offset {fr - 1}')


def test_no_aggregation_is_identity(tmp_path):
    """look_back = look_forward = 0 returns the key frame unchanged (but for
    the ego-car body filter)."""
    root = str(tmp_path)
    poses = {5: _pose(10.0, 0.3)}
    landmarks = np.asarray([[8.0, 2.0, 0.0], [30.0, 5.0, 1.0]])
    _write_sequence(root, poses, landmarks)
    agg = _load_both(root, '0000005')
    inv = np.linalg.inv(poses[5])
    expect = landmarks @ inv[:3, :3].T + inv[:3, 3]
    np.testing.assert_allclose(agg[:, :3], expect, atol=1e-5)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return j_generate(str(tmp_path_factory.mktemp('ds')), splits=('val',),
                      frames_per_sequence=4, n_objects=4, img_hw=(64, 128),
                      write_images=False)


def test_dataset_consumes_aggregated_cloud(tree):
    """Dataset level: look_back = look_forward = 1 trims the frame index by
    the window and more than doubles the valid points of each sample; the
    neighbours' timestamps ride in the last feature."""
    base = dict(use_cam=False, use_lidar=True, use_radar=False)
    ds0 = AiMotiveDataset(tree, tcfg.tiny_test_config(**base), split='val')
    ds1 = AiMotiveDataset(tree, tcfg.tiny_test_config(look_back=1, look_forward=1, **base),
                          split='val')
    assert len(ds0) == 4 and len(ds1) == 2   # 4 frames, a window of 1 + 1: 2 key frames

    n0 = int(ds0[1]['point_mask'].sum())   # key frame 2 without the window
    n1 = int(ds1[0]['point_mask'].sum())   # the same key frame, 3 frames
    assert n1 > 2 * n0, (n0, n1)
    s = ds1[0]
    ts = s['points'][s['point_mask']][:, -1]
    assert len(np.unique(np.round(ts, 6))) >= 2


@pytest.mark.parametrize('look_back,look_forward', [(1, 0), (1, 1), (0, 2)])
def test_aggregated_batch_equals_jax(tree, look_back, look_forward):
    """Every array of every sample and of the collated batch byte-equal to
    the JAX loader's with the window on, the frame index included."""
    kw = dict(use_cam=False, use_lidar=True, use_radar=True, look_back=look_back,
              look_forward=look_forward)
    jd = JDataset(tree, jcfg.tiny_test_config(**kw), split='val')
    td = AiMotiveDataset(tree, tcfg.tiny_test_config(**kw), split='val')
    assert td.dataset_index == jd.dataset_index
    assert len(td) == 4 - look_back - look_forward
    js, ts = [jd[i] for i in range(len(jd))], [td[i] for i in range(len(td))]
    for a, b in zip(js + [j_collate(js)], ts + [collate_aim(ts)]):
        assert list(a) == list(b)
        for k in a:
            if k == 'path':
                assert a[k] == b[k]
            else:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                assert a[k].tobytes() == b[k].tobytes(), k
