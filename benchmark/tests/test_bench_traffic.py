"""The benchmark's frozen generators give the port's arrays."""
import numpy as np
import pytest
import torch

import bench_tiny  # noqa: F401  (the repository root on the path)
from benchmark.harness import frozen, traffic as traffic_mod
from benchmark.harness.main import load_json, ROOT
from mm_training_tpu_torch.configs import tiny_test_config
from mm_training_tpu_torch.data.fake_batch import make_fake_batch, random_bda_matrices
from mm_training_tpu_torch.exps.kernel_inputs import lidar_like_points
from mm_training_tpu_torch.training import draw_train_randoms

SEEDS = [0, 7, 2 ** 31 + 5]


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('use_cam', [False, True])
def test_fake_batch_is_the_ports(seed, use_cam):
    cfg = tiny_test_config(use_cam=use_cam, batch_size=2)
    ours = frozen.make_fake_batch(cfg, 2, seed, 11)
    theirs = make_fake_batch(cfg, seed=seed, n_objects=11)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.mark.parametrize('seed', SEEDS)
def test_lidar_like_points_are_the_ports(seed):
    cfg = tiny_test_config(batch_size=2)
    pts, mask = frozen.lidar_like_points(cfg, 3, seed, 5000)
    tp, tm = lidar_like_points(cfg, 3, seed, device='cpu', points=5000)
    np.testing.assert_array_equal(pts, tp.numpy())
    np.testing.assert_array_equal(mask, tm.numpy())


@pytest.mark.parametrize('seed', SEEDS)
def test_bda_matrices_are_the_ports(seed):
    cfg = tiny_test_config()
    np.testing.assert_array_equal(frozen.random_bda_matrices(cfg, 4, seed),
                                  random_bda_matrices(4, seed))


def test_draws_are_the_ports_layout():
    cfg = tiny_test_config(use_cam=True)
    shape = (2, 1, 2, 64, 128, 3)
    ours = frozen.draw_train_randoms(cfg, shape, torch.Generator().manual_seed(3), 'cpu')
    theirs = draw_train_randoms(cfg, shape, torch.Generator().manual_seed(3), 'cpu')
    assert torch.equal(ours['flipped'], theirs['flipped'])
    for a, b in zip(ours['dropout'], theirs['dropout']):
        assert torch.equal(a, b) and a.stride() == b.stride()


def test_every_seed_gets_the_same_box_counts_in_another_order():
    t = load_json(ROOT / 'benchmark' / 'traffic' / 'train_b4.json')
    a, b = traffic_mod.box_counts(t, 1), traffic_mod.box_counts(t, 2 ** 40)
    assert sorted(a.ravel()) == sorted(b.ravel()) and not np.array_equal(a, b)
    assert a.min() == t['boxes_per_frame'][0] and a.max() == t['boxes_per_frame'][1]


def test_pool_batches_all_differ():
    cfg = tiny_test_config(use_cam=True, batch_size=2, max_points_per_frame=2048)
    t = dict(load_json(ROOT / 'benchmark' / 'traffic' / 'train_b4.json'), batch_size=2,
             points_per_frame=2048, boxes_per_frame=[2, 8])
    pool = traffic_mod.make_pool(cfg, t, 5)
    assert len(pool) == t['pool']
    for i in range(len(pool)):
        for j in range(i):
            assert not np.array_equal(pool[i]['points'], pool[j]['points'])
            assert not np.array_equal(pool[i]['imgs'], pool[j]['imgs'])
    again = traffic_mod.make_pool(cfg, t, 5)
    assert all(np.array_equal(a[k], b[k]) for a, b in zip(pool, again) for k in a)
