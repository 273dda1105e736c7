"""The port's PrefetchLoader (``training/loader.py``): the counterparts of
``tests/test_training/test_loader.py`` (batching, epoch shuffling,
``pad_last``, producer exceptions, abandoned iterations, process workers)
and the JAX loader's batches on the same tree and seed."""
import threading
import time

import numpy as np
import pytest

import mm_training_tpu.configs as jcfg
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu.data import AiMotiveDataset as JDataset
from mm_training_tpu.data.synthetic import generate_synthetic_dataset
from mm_training_tpu.training.loader import PrefetchLoader as JLoader
from mm_training_tpu_torch.data import AiMotiveDataset
from mm_training_tpu_torch.training.loader import PrefetchLoader, stack_batches


class _ArrayDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'x': np.full((3,), float(i), np.float32), 'path': f'p{i}'}


class _ExplodingDataset(_ArrayDataset):
    def __getitem__(self, i):
        if i >= 2:
            raise ValueError('boom')
        return super().__getitem__(i)


class _EpochDataset(_ArrayDataset):
    """Sample value depends on (index, epoch): catches stale forked-worker
    epoch state in process mode."""

    def __init__(self, n):
        super().__init__(n)
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __getitem__(self, i):
        return {'x': np.full((3,), float(i) + 100.0 * self.epoch, np.float32),
                'path': f'p{i}'}


def test_batching_and_drop_last():
    ld = PrefetchLoader(_ArrayDataset(7), batch_size=2, shuffle=False, num_workers=2)
    batches = list(ld)
    assert len(batches) == len(ld) == 3
    assert batches[0]['x'].shape == (2, 3)
    np.testing.assert_allclose(batches[0]['x'][:, 0], [0, 1])
    assert batches[0]['path'] == ['p0', 'p1']
    ld.close()


def test_shuffle_changes_per_epoch_deterministically():
    ld = PrefetchLoader(_ArrayDataset(8), batch_size=2, shuffle=True, num_workers=1, seed=3)
    epochs = []
    for epoch in (0, 0, 1):
        ld.set_epoch(epoch)
        epochs.append(np.concatenate([b['x'][:, 0] for b in ld]))
    np.testing.assert_array_equal(epochs[0], epochs[1])
    assert not np.array_equal(epochs[0], epochs[2])
    assert sorted(epochs[0].tolist()) == sorted(epochs[2].tolist())
    ld.close()


def test_producer_exception_propagates():
    ld = PrefetchLoader(_ExplodingDataset(8), batch_size=2, shuffle=False, num_workers=1)
    with pytest.raises(ValueError, match='boom'):
        list(ld)
    ld.close()


def test_pad_last_marks_n_valid():
    ld = PrefetchLoader(_ArrayDataset(10), batch_size=4, shuffle=False, num_workers=2,
                        drop_last=False, pad_last=True)
    batches = list(ld)
    assert len(batches) == 3
    assert all(b['x'].shape[0] == 4 for b in batches)
    assert batches[0]['n_valid'] == 4
    assert batches[2]['n_valid'] == batches[2]['n_valid_global'] == 2
    np.testing.assert_array_equal(batches[2]['sample_valid'], [True, True, False, False])
    np.testing.assert_array_equal(batches[2]['x'][2], batches[2]['x'][3])
    ld.close()


def test_skip_batches_starts_mid_epoch_once():
    ld = PrefetchLoader(_ArrayDataset(8), batch_size=2, shuffle=True, num_workers=1, seed=5)
    full = [b['path'] for b in ld]
    ld.skip_batches(3)
    assert [b['path'] for b in ld] == full[3:]
    assert [b['path'] for b in ld] == full           # back to batch 0
    assert stack_batches(list(ld)[:2])['x'].shape == (2, 2, 3)
    ld.close()


def test_abandoned_iteration_releases_producer_thread():
    """Abandoning an iteration (an init fetch, a max_batches-capped eval)
    lets the producer exit rather than park in q.put() for good."""
    ld = PrefetchLoader(_ArrayDataset(64), batch_size=1, shuffle=False, num_workers=1,
                        prefetch=1)
    g0 = iter(ld)
    next(g0)          # spawn the persistent pool worker before baselining
    g0.close()
    time.sleep(1.0)
    base = threading.active_count()
    for _ in range(8):
        g = iter(ld)
        next(g)
        g.close()
    deadline = time.time() + 15.0
    while time.time() < deadline and threading.active_count() > base:
        time.sleep(0.2)
    assert threading.active_count() <= base, \
        f'{threading.active_count() - base} producer threads still alive'
    ld.close()


def test_process_worker_mode_matches_thread_mode():
    """worker_mode='process' (forked workers) yields the thread pool's
    batches, epoch-dependent sample state included (the task carries the
    epoch to the forked child)."""
    def run(mode):
        ld = PrefetchLoader(_EpochDataset(8), batch_size=2, shuffle=True, num_workers=2,
                            seed=3, worker_mode=mode)
        try:
            out = []
            for epoch in (0, 1):
                ld.set_epoch(epoch)
                out.extend(b['x'] for b in ld)
            return out
        finally:
            ld.close()

    ref, got = run('thread'), run('process')
    assert len(ref) == len(got) == 8
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('aim_loader'))
    generate_synthetic_dataset(root, splits=('train', 'val'), frames_per_sequence=5,
                               n_objects=6, write_images=False, lidar_format='laz',
                               n_ground_points=2000)
    return root


@pytest.mark.parametrize('split', ['train', 'val'])
def test_batches_equal_jax_loader(tree, split):
    """On the same tree and seed the port's loader yields the JAX loader's
    batches: the train split shuffled and dropping its last frame, at epochs
    0 and 1; the val split padded (``n_valid``, ``sample_valid``)."""
    train = split == 'train'
    kw = dict(shuffle=train, num_workers=3, seed=4, drop_last=train, pad_last=not train)
    jl = JLoader(JDataset(tree, jcfg.lidar_radar(max_points_per_frame=3000, seed=4), split),
                 2, **kw)
    tl = PrefetchLoader(AiMotiveDataset(tree, tcfg.lidar_radar(max_points_per_frame=3000,
                                                                seed=4), split), 2, **kw)
    try:
        for epoch in ((0, 1) if train else (0,)):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            want, got = list(jl), list(tl)
            assert len(got) == len(want) == (2 if train else 3)
            for a, b in zip(want, got):
                assert list(a) == list(b)
                for k in a:
                    if isinstance(a[k], np.ndarray):
                        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
                    else:
                        assert a[k] == b[k], k
    finally:
        jl.close()
        tl.close()
