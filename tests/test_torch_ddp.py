"""Data parallelism of the port (``mm_training_tpu_torch/parallel``): a gloo
world of 2 CPU processes against one process on the same global batch.

One module fixture starts the world (``parallel/dryrun.py::spawn_ranks`` on
``tests/torch_ddp_worker.py``, which imports the port only), and while its
ranks run, this process runs the same
cases without a process group on the whole global batch. Each case is a
test of its own: the BatchNorm statistics, plain and masked (a rank whose
mask is empty), and their gradients; the loss normalizers with one positive
in the whole batch, the clamp that a mean of counts over ranks (mmdet's
``reduce_mean``) gets wrong, and with uneven objects, which rank-local
counts get wrong; the tiny L+R and L+R+C train steps in float64 (a global batch of 2); the eval
step's global losses on a batch whose trailing rows are padding (rank 1
holds only padding) and the mAP pooled with ``all_gather_object``. The
world-1 step is held against the JAX package by ``test_torch_train.py`` and
``test_torch_train_cam*.py``.

The detection and depth losses are float32 sums in both packages (the pred
maps are cast before the losses, in the float64 steps too), so a loss
summed over two ranks' shares differs from the one-process sum by float32
rounding: held to 1e-6 relative. Their gradients are elementwise with the
same normalizers, and the rest of the float64 step is held to 1e-9.
"""
import concurrent.futures
from unittest import mock

import numpy as np
import pytest
import torch

from mm_training_tpu_torch import parallel
from mm_training_tpu_torch.parallel import dryrun
from mm_training_tpu_torch.training.loader import PrefetchLoader
from tests import torch_ddp_worker as cases

WORLD = 2
RANK_ROWS = [(r * cases.GLOBAL_B // WORLD, (r + 1) * cases.GLOBAL_B // WORLD)
             for r in range(WORLD)]


@pytest.fixture(scope='module')
def world():
    """(the one-process results, each rank's results)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(dryrun.spawn_ranks, WORLD, 'tests.torch_ddp_worker:rank_cases',
                             device='cpu')
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            single = cases.run_cases()
        finally:
            torch.set_num_threads(threads)
        ranks = future.result()
    assert [(x['rank'], x['world']) for x in ranks] == [(r, WORLD) for r in range(WORLD)]
    return single, ranks


class _Rows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'x': np.full((2,), float(i), np.float32), 'path': f'p{i}'}


def _as_rank(rank, world):
    return (mock.patch('mm_training_tpu_torch.parallel.mesh.process_index', lambda: rank),
            mock.patch('mm_training_tpu_torch.parallel.mesh.process_count', lambda: world))


@pytest.mark.parametrize('world_size', [1, 2, 4])
def test_rank_rows_concatenate_to_the_global_batch(world_size):
    """``process_batch_bounds`` and ``PrefetchLoader(process_rows)``: the
    ranks' rows of every shuffled train batch and of every eval batch
    concatenate to the one-process batch, the trailing eval batch (3 valid
    of 4) padded to the global size first; in a world of 4 the last rank
    holds only padding, with ``n_valid`` 0 and the global ``n_valid_global``."""
    ds, gb = _Rows(11), 4
    want = {split: list(PrefetchLoader(ds, gb, shuffle=split == 'train', seed=3,
                                       drop_last=split == 'train', pad_last=split != 'train',
                                       num_workers=1))
            for split in ('train', 'val')}
    got = {'train': [], 'val': []}
    for rank in range(world_size):
        a, b = _as_rank(rank, world_size)
        with a, b:
            rows = parallel.process_batch_bounds(gb)
        assert rows == (rank * gb // world_size, (rank + 1) * gb // world_size)
        for split in got:
            got[split].append(list(PrefetchLoader(
                ds, gb, shuffle=split == 'train', seed=3, drop_last=split == 'train',
                pad_last=split != 'train', num_workers=1, process_rows=rows)))
    assert [len(b) for b in want.values()] == [2, 3]
    for split, batches in want.items():
        for i, w in enumerate(batches):
            parts = [g[i] for g in got[split]]
            np.testing.assert_array_equal(np.concatenate([p['x'] for p in parts]), w['x'])
            assert sum((p['path'] for p in parts), []) == w['path']
            if split == 'val':
                np.testing.assert_array_equal(
                    np.concatenate([p['sample_valid'] for p in parts]), w['sample_valid'])
                assert sum(p['n_valid'] for p in parts) == w['n_valid']
                assert {p['n_valid_global'] for p in parts} == {w['n_valid']}
    last = [g[-1] for g in got['val']]
    assert want['val'][-1]['n_valid'] == 3
    if world_size == 4:
        assert last[-1]['n_valid'] == 0 and not last[-1]['sample_valid'].any()
    a, b = _as_rank(0, 3)
    with a, b, pytest.raises(ValueError, match='does not split'):
        parallel.process_batch_bounds(gb)


def _concat(ranks, case, key):
    return np.concatenate([r[case][key] for r in ranks])


@pytest.mark.parametrize('case', ['bn_plain', 'bn_masked'])
def test_batch_norm_statistics_are_global(world, case):
    """Train-mode BatchNorm on two ranks: the output, the input gradient
    (through the all-reduce's backward), the summed parameter gradients and
    the running statistics of the global batch (float64, 1e-12); the masked
    form with rank 1's mask empty. One rank's own statistics differ."""
    single, ranks = world
    want = single[case]
    for key in ('y', 'dx'):
        np.testing.assert_allclose(_concat(ranks, case, key), want[key], rtol=1e-12,
                                   atol=1e-12, err_msg=key)
    for key in ('dweight', 'dbias'):
        np.testing.assert_allclose(sum(r[case][key] for r in ranks), want[key], rtol=1e-12,
                                   atol=1e-12, err_msg=key)
    for r in ranks:
        for key in ('running_mean', 'running_var'):
            np.testing.assert_allclose(r[case][key], want[key], rtol=1e-12, atol=1e-12)
    if case == 'bn_plain':
        local = cases.bn_case(False, rows=RANK_ROWS[0])
        assert np.abs(local['running_var'] - want['running_var']).max() > 1e-3
    else:       # rank 1 alone has no active pixel: NaN statistics, as flax's
        local = cases.bn_case(True, rows=RANK_ROWS[1])
        assert np.isnan(local['running_var']).all() and np.isfinite(want['running_var']).all()


def _losses_with(reduce, fn, objects=None):
    """The ranks' losses of ``fn`` on their rows in this process, with
    ``parallel.all_reduce_sum`` replaced by ``reduce``."""
    args = () if objects is None else (objects,)
    with mock.patch.object(parallel, 'all_reduce_sum', reduce):
        return [float(fn(*args, rows=rows)['loss']) for rows in RANK_ROWS]


def _global_counts(fn, objects=None):
    seen = []
    args = () if objects is None else (objects,)

    def keep(t):
        seen.append(t.clone())
        return t
    with mock.patch.object(parallel, 'all_reduce_sum', keep):
        fn(*args, rows=(0, cases.GLOBAL_B))
    return seen[0]


@pytest.mark.parametrize('case,objects', [('det_one_positive', cases.ONE_POSITIVE),
                                          ('det_uneven', cases.UNEVEN)])
def test_detection_loss_normalizers_are_global(world, case, objects):
    """``detection_loss``: the ranks' shares sum to the one-process loss and
    each rank's heatmap gradient is its rows' of the one-process gradient.
    With one positive in the whole batch, mmdet's mean of counts over ranks
    (0.5, clamped to 1, then the ranks' mean) halves the heatmap loss; with
    uneven objects the ranks' own counts give another loss."""
    single, ranks = world
    want = float(single[case]['loss'])
    got = sum(float(r[case]['loss']) for r in ranks)
    assert abs(got - want) <= 1e-6 * want
    for t in range(len(single[case]['dheatmap'])):
        np.testing.assert_allclose(np.concatenate([r[case]['dheatmap'][t] for r in ranks]),
                                   single[case]['dheatmap'][t], rtol=1e-6, atol=1e-12)
    if case == 'det_one_positive':
        counts = _global_counts(cases.detection_case, objects)
        assert sorted(counts.tolist()).count(1.0) == 2 and counts.sum() == 2  # one cell, one box
        mean = sum(_losses_with(lambda t: counts / WORLD, cases.detection_case, objects)) / WORLD
        assert abs(mean - want) > 0.05 * want
    else:
        local = sum(_losses_with(lambda t: t, cases.detection_case, objects))
        assert abs(local - want) > 0.05 * want


def test_depth_loss_normalizer_is_global(world):
    """``depth_loss_fn`` with one foreground pixel in the whole batch: the
    shares sum to the one-process loss, the gradients are its rows'; the
    mean of counts over ranks halves it."""
    single, ranks = world
    want = float(single['depth_one_fg']['loss'])
    assert abs(sum(float(r['depth_one_fg']['loss']) for r in ranks) - want) <= 1e-6 * want
    np.testing.assert_allclose(_concat(ranks, 'depth_one_fg', 'dpreds'),
                               single['depth_one_fg']['dpreds'], rtol=1e-6, atol=1e-12)
    counts = _global_counts(cases.depth_case)
    assert float(counts) == 1.0
    mean = sum(_losses_with(lambda t: counts / WORLD, cases.depth_case)) / WORLD
    assert abs(mean - want / 2) <= 1e-6 * want


@pytest.mark.parametrize('case', ['train_lidar', 'train_camera'])
def test_train_step_equals_one_process(world, case):
    """The tiny L+R step and the L+R+C step (each rank drawing the flips and
    dropout of the global batch and keeping its rows) on two ranks equal one
    process on the global batch in float64: the losses to 1e-6 (float32
    sums), the gradient norm to 1e-9, every BatchNorm statistic to 1e-9,
    the parameters to 1e-9 where the gradient exceeds 1e-4 of its tensor's
    largest, and Adam's first moments (the clipped gradients) to 1e-7 of
    each tensor's largest (1e-3 of the model's largest at least: a bias
    right before a train-mode BatchNorm has a gradient of rounding noise).
    Elsewhere Adam divides a gradient near its eps (1e-8) by itself, which
    turns the float64 gradients' cancellation (the BatchNorm backward
    subtracts near-equal sums) into an update that moves by up to ~3e-5 lr
    between two orders of summation: held there to 1e-4 lr. Both ranks hold
    the same bits, and the step made its all-reduces."""
    single, ranks = world
    want = single[case]
    lr = want['lr']
    for r in ranks:
        assert r[case]['lr'] == lr
        assert r[case]['metrics'] == ranks[0][case]['metrics']
        assert r[case]['counts']['all_reduce'] > 0
        for m, w in zip(r[case]['metrics'], want['metrics']):
            for k in ('train_loss', 'train_detection_loss', 'train_depth_loss'):
                assert abs(m[k] - w[k]) <= 1e-6 * max(abs(w[k]), 1e-30), k
            assert abs(m['grad_norm'] - w['grad_norm']) <= 1e-9 * w['grad_norm']
        for group in ('mu', 'params', 'buffers'):
            for name, v in r[case][group].items():
                np.testing.assert_array_equal(v, ranks[0][case][group][name])
        for name, v in r[case]['buffers'].items():
            np.testing.assert_allclose(v, want['buffers'][name], rtol=1e-9, atol=1e-9,
                                       err_msg=name)
        model_top = max(np.abs(mu).max() for mu in want['mu'].values())
        for name, mu in want['mu'].items():
            top = np.abs(mu).max()
            assert (np.abs(r[case]['mu'][name] - mu).max()
                    <= 1e-7 * max(top, 1e-3 * model_top)), name
            d = np.abs(r[case]['params'][name] - want['params'][name])
            strong = np.abs(mu) > 1e-4 * top
            assert d[strong].max(initial=0) <= 1e-9 and d.max() <= 1e-4 * lr, name
    assert want['counts']['all_reduce'] == 0
    if case == 'train_camera':
        assert want['metrics'][0]['train_depth_loss'] > 1.0


def test_eval_step_and_pooled_map_equal_one_process(world):
    """The eval step on a global batch whose second sample is padding (rank
    1's rows are all padding): the same global losses on both ranks as one
    process gives, the decoded boxes of each rank's rows the one
    process's, and the BEV mAP pooled over the ranks with
    ``all_gather_object`` equal to one process's."""
    single, ranks = world
    want = single['eval_padded']
    for r in ranks:
        for k, v in want['metrics'].items():
            assert abs(r['eval_padded']['metrics'][k] - v) <= 1e-6 * max(abs(v), 1e-30), k
    for key in ('valid', 'labels'):
        np.testing.assert_array_equal(_concat(ranks, 'eval_padded', key), want[key])
    for key in ('boxes', 'scores'):
        np.testing.assert_allclose(_concat(ranks, 'eval_padded', key), want[key], atol=1e-9)
    assert want['map']['ap_auc'] > 0.5
    for k, v in want['map'].items():
        assert ranks[0]['eval_padded']['map'][k] == pytest.approx(v, abs=1e-9), k
