"""The port's offline tools against the JAX package's: the cases of
``tests/test_data/test_scripts.py`` (OpenPCDet export, aiMotive depth
grids) with every file the port writes byte-equal to the JAX tool's on the
same tree; the depth-grid binning of ``tests/test_data/test_depth_gt.py``;
the nuScenes depth bins; ``generate_info`` on a stand-in devkit and
``gen_info``'s refusal without the devkit; and the loader bench at a tiny
size."""
import glob
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_training_tpu_torch.data import generate_synthetic_dataset


@pytest.fixture(scope='module')
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('scripts_ds')
    return generate_synthetic_dataset(str(root), splits=('val',), frames_per_sequence=2,
                                      n_objects=4, img_hw=(64, 128))


def _same_files(a, b, pattern):
    """The files under ``a`` matching ``pattern``, each byte-equal to its
    twin under ``b``; returns them."""
    files = sorted(glob.glob(os.path.join(a, pattern), recursive=True))
    twins = sorted(glob.glob(os.path.join(b, pattern), recursive=True))
    assert [os.path.relpath(f, a) for f in files] == [os.path.relpath(f, b) for f in twins]
    for f, t in zip(files, twins):
        with open(f, 'rb') as x, open(t, 'rb') as y:
            assert x.read() == y.read(), f
    return files


def test_export_openpcdet(synth_root, tmp_path):
    from mm_training_tpu.scripts.export_openpcdet import main as j_main
    from mm_training_tpu_torch.scripts.export_openpcdet import main
    out, j_out = str(tmp_path / 'opcd'), str(tmp_path / 'jax')
    main(['--data-root', synth_root, '--split', 'val', '--out', out])
    j_main(['--data-root', synth_root, '--split', 'val', '--out', j_out])
    pts = _same_files(out, j_out, 'val/points/*.npy')
    lbls = _same_files(out, j_out, 'val/labels/*.txt')
    assert len(pts) == len(lbls) == 2
    arr = np.load(pts[0])
    assert arr.ndim == 2 and arr.shape[1] == 4 and arr.dtype == np.float32   # x y z intensity
    line = open(lbls[0]).readline().split()
    assert len(line) == 8                               # x y z dx dy dz yaw category
    float(line[0])


@pytest.mark.parametrize('workers', [1, 2])
def test_gen_depth_gt(synth_root, tmp_path, workers):
    """aiMotive mode: one [cameras, H/16, W/16] grid a frame, the JAX tool's
    bytes; the port's with its pool of spawned workers too (the JAX tool's
    pool forks, so it takes one worker in this process, where JAX's
    threads run)."""
    from mm_training_tpu.scripts.gen_depth_gt import main as j_main
    from mm_training_tpu_torch.scripts.gen_depth_gt import main
    out, j_out = str(tmp_path / 'dgt'), str(tmp_path / 'jax')
    argv = ['--data-root', synth_root, '--split', 'val', '--height', '64', '--width', '128']
    main(argv + ['--out', out, '--workers', str(workers)])
    j_main(argv + ['--out', j_out, '--workers', '1'])
    files = _same_files(out, j_out, '**/*_depth.npy')
    assert len(files) == 2
    grid = np.load(files[0])
    assert grid.ndim == 3 and grid.shape[1:] == (4, 8)
    assert (grid > 0).any() and float(grid.max()) < 1e4   # empty cells 0, not the sentinel


def test_depth_gt_binning_matches_projection():
    """``depth_grid_to_onehot`` on a projected grid equals the projection
    path's labels (the same binning), in both packages; the grids of the
    two tools equal."""
    from mm_training_tpu.ops.depth_labels import depth_grid_to_onehot as j_onehot
    from mm_training_tpu.ops.depth_labels import depth_labels_single_cam
    from mm_training_tpu.scripts.gen_depth_gt import depth_grid_numpy as j_grid
    from mm_training_tpu_torch.ops.depth_labels import depth_grid_to_onehot, depth_labels
    from mm_training_tpu_torch.scripts.gen_depth_gt import depth_grid_numpy
    rng = np.random.default_rng(0)
    cam_pts = np.column_stack([rng.uniform(-10, 10, 500), rng.uniform(-10, 10, 500),
                               rng.uniform(2, 25, 500)]).astype(np.float32)
    extr = np.eye(4, dtype=np.float32)
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0] = intr[1, 1] = 60.0
    intr[0, 2], intr[1, 2] = 64.0, 32.0
    d_bound, bins = (2.0, 27.2, 0.5), 50
    grid = depth_grid_numpy(cam_pts, extr, intr, (64, 128), 16)
    assert grid.tobytes() == j_grid(cam_pts, extr, intr, (64, 128), 16).tobytes()
    direct = depth_labels(torch.from_numpy(cam_pts)[None], torch.ones(1, 500, dtype=torch.bool),
                          torch.from_numpy(extr)[None, None], torch.from_numpy(intr)[None, None],
                          (64, 128), 16, d_bound, bins)[0]
    via_grid = depth_grid_to_onehot(torch.from_numpy(grid), d_bound, bins)
    np.testing.assert_array_equal(via_grid.numpy(), direct.numpy())
    assert via_grid[..., 1:].sum() > 10
    want = depth_labels_single_cam(jnp.asarray(cam_pts), jnp.ones((500,), bool),
                                   jnp.asarray(extr), jnp.asarray(intr), (64, 128), 16,
                                   d_bound, bins)
    np.testing.assert_array_equal(np.asarray(j_onehot(jnp.asarray(grid), d_bound, bins)),
                                  np.asarray(want))
    np.testing.assert_array_equal(via_grid.numpy(), np.asarray(want))


@pytest.fixture(scope='module')
def nusc_tree(tmp_path_factory):
    from mm_training_tpu_torch.exps.nuscenes_tree import write_nuscenes_tree
    root = str(tmp_path_factory.mktemp('nusc'))
    tree = write_nuscenes_tree(root, splits={'train': 2, 'val': 2}, img_hw=(90, 160),
                               points=2000, sweeps=3, anns=10)
    return root, tree


def test_gen_depth_gt_nuscenes_bins_match_jax(nusc_tree, tmp_path):
    """nuScenes mode: one (u, v, depth) bin a camera of every sample of the
    split, the JAX tool's bytes."""
    from mm_training_tpu.scripts.gen_depth_gt import main as j_main
    from mm_training_tpu_torch.scripts.gen_depth_gt import main
    root, _ = nusc_tree
    out, j_out = str(tmp_path / 'bins'), str(tmp_path / 'jax')
    for split in ('train', 'val'):
        argv = ['--dataset', 'nuscenes', '--data-root', root, '--split', split, '--workers', '1']
        main(argv + ['--out', out])
        j_main(argv + ['--out', j_out])
    files = _same_files(out, j_out, 'depth_gt/*.bin')
    assert len(files) == 4 * 6
    uvd = np.fromfile(files[0], np.float32).reshape(-1, 3)
    assert len(uvd) > 0 and (uvd[:, 2] > 0.5).all()


def test_generate_info_matches_jax(nusc_tree):
    """Both packages' ``generate_info`` on the stand-in devkit give equal
    infos (sweeps newest first, at most ``max_sweeps``), and they are what
    the tree's pickles hold."""
    from mm_training_tpu.scripts.gen_info import generate_info as j_generate_info
    from mm_training_tpu_torch.scripts.gen_info import generate_info
    root, tree = nusc_tree
    nusc = tree['nusc']
    for scenes, sweeps in (({'scene-train'}, 3), ({'scene-val'}, 1), ({'scene-train',
                                                                         'scene-val'}, 0)):
        infos = generate_info(nusc, scenes, max_sweeps=sweeps)
        assert pickle.dumps(infos) == pickle.dumps(j_generate_info(nusc, scenes, sweeps))
        assert all(len(i['sweeps']) <= sweeps for i in infos)
    infos = generate_info(nusc, {'scene-train'}, max_sweeps=3)
    with open(tree['info_paths']['train'], 'rb') as f:
        assert pickle.dumps(pickle.load(f)) == pickle.dumps(infos)
    assert len(infos) == 2 and len(infos[1]['sweeps']) == 3 and len(infos[1]['cam_infos']) == 6
    stamps = [s['timestamp'] for s in infos[1]['sweeps']]
    assert stamps == sorted(stamps, reverse=True) and stamps[0] < infos[1]['timestamp']


def test_gen_info_without_the_devkit_exits_as_jax_does(monkeypatch):
    from mm_training_tpu.scripts.gen_info import main as j_main
    from mm_training_tpu_torch.scripts.gen_info import main
    monkeypatch.setitem(sys.modules, 'nuscenes', None)
    argv = ['--data-root', '/nonexistent']
    with pytest.raises(SystemExit) as got:
        main(argv)
    with pytest.raises(SystemExit) as want:
        j_main(argv)
    assert 'nuscenes-devkit' in str(got.value) and str(got.value) == str(want.value)


def test_loader_bench_at_a_tiny_size(tmp_path, capsys):
    """The fixture (64 x 128 JPEGs with the fisheyes, 2000 ground points),
    its LAZ twin, the loader's rate against ``--device-rate`` and one
    dataset item's host ms; the thread sweep and the process mode."""
    import json

    from mm_training_tpu_torch.data import loader_bench
    root = str(tmp_path / 'fixture')
    out = loader_bench.main(['--device-rate', '1e9', '--root', root, '--laz', '--sweep',
                             '--img-hw', '64', '128', '--ground-points', '2000',
                             '--batches', '2', '--num-workers', '2'])
    assert out['lidar_format'] == 'laz' and out['img_hw'] == [64, 128]
    assert out['loader_sps'] > 0 and out['getitem_ms'] > 0 and out['process_sps'] > 0
    assert out['device_rate_to_beat'] == 1e9 and out['feeds_device'] is False
    assert sorted(out['thread_sweep']) == [1, 2, 4, 8]
    assert glob.glob(os.path.join(root + '_laz', '**', '*.laz'), recursive=True)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])['batch_size'] == 2
