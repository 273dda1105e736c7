"""The model axis of the port (``parallel/spatial.py``): the fused BEV's head
sharded along W over ``model_parallel`` ranks equals one process on the
global batch, on the CPU (gloo ranks in child processes,
``parallel/dryrun.py::spawn_ranks``).

One module fixture starts two worlds at once, ``model_parallel=2`` alone (2
ranks) and ``model_parallel=2`` x ``data_parallel=2`` (4 ranks), and while
their ranks run, this process runs the same cases without a group
(``tests/torch_mp_worker.py::step_cases``): the narrow tiny L+R train step in
float64 at a global batch of 2, then from fresh weights the eval step on a
batch whose second sample is padding, and the predict step with the flip
ensemble and on folded weights. The one-process steps are held against the
JAX package by ``test_torch_train.py``, ``test_torch_tta.py`` and
``test_torch_bn_fold.py``.

The losses are float32 sums (the pred maps are cast before the losses), so
a loss summed over the ranks' shares differs from the one-process sum by
float32 rounding: held to 1e-6 relative. The rest of the float64 step is
held as ``test_torch_ddp.py`` holds the data-parallel step.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

from mm_training_tpu_torch.parallel import dryrun
from tests import torch_mp_worker as cases

WORLDS = (2, 4)          # model_parallel=2 alone, and x data_parallel=2


@pytest.fixture(scope='module')
def worlds():
    """({world: each rank's results}, the one-process results)."""
    spec = cases.step_spec()
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {w: pool.submit(dryrun.spawn_ranks, w, 'tests.torch_mp_worker:step_cases',
                                  (spec,), device='cpu', model_parallel=2)
                   for w in WORLDS}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            single = cases.step_cases(spec)
        finally:
            torch.set_num_threads(threads)
        return {w: f.result() for w, f in futures.items()}, single


def _rows(world, rank):
    """The global rows rank ``rank`` holds: data index ``rank % (world //
    2)`` of the (2, world // 2) layout, model peers the same rows."""
    dp = world // 2
    j = rank % dp
    per = cases.STEP_B // dp
    return slice(j * per, (j + 1) * per)


@pytest.mark.parametrize('world', WORLDS)
def test_train_step_equals_one_process(worlds, world):
    """The losses to 1e-6 (float32 sums), the gradient norm to 1e-9, every
    BatchNorm statistic to 1e-9, the parameters to 1e-9 where the gradient
    exceeds 1e-4 of its tensor's largest and to 1e-4 lr elsewhere, Adam's
    first moments (the clipped gradients) to 1e-7 of each tensor's largest
    (1e-3 of the model's largest at least); every rank the same bits; the
    halos and the maps crossed the model group in all-gathers."""
    ranks, single = worlds
    want = single['train']
    lr = want['lr']
    got = [r['train'] for r in ranks[world]]
    model_top = max(np.abs(mu).max() for mu in want['mu'].values())
    for r in got:
        assert r['lr'] == lr
        assert r['metrics'] == got[0]['metrics']
        assert r['collectives']['all_gather'] > 0
        for k in ('train_loss', 'train_detection_loss'):
            assert abs(r['metrics'][k] - want['metrics'][k]) <= 1e-6 * abs(want['metrics'][k])
        assert r['metrics']['train_depth_loss'] == 0.0
        assert (abs(r['metrics']['grad_norm'] - want['metrics']['grad_norm'])
                <= 1e-9 * want['metrics']['grad_norm'])
        for group in ('mu', 'params', 'buffers'):
            for name, v in r[group].items():
                np.testing.assert_array_equal(v, got[0][group][name])
        for name, v in r['buffers'].items():
            np.testing.assert_allclose(v, want['buffers'][name], rtol=1e-9, atol=1e-9,
                                       err_msg=name)
        for name, mu in want['mu'].items():
            top = np.abs(mu).max()
            assert np.abs(r['mu'][name] - mu).max() <= 1e-7 * max(top, 1e-3 * model_top), name
            d = np.abs(r['params'][name] - want['params'][name])
            strong = np.abs(mu) > 1e-4 * top
            assert d[strong].max(initial=0) <= 1e-9 and d.max() <= 1e-4 * lr, name
    assert want['collectives']['all_gather'] == 0


@pytest.mark.parametrize('world', WORLDS)
def test_eval_step_equals_one_process(worlds, world):
    """The eval step's global losses the same on every rank as one process
    gives (the padded sample dropped), each rank's decoded boxes those of
    its rows, and the first sample's heatmaps taken from the whole maps."""
    ranks, single = worlds
    want = single['eval']
    for rank, r in enumerate(ranks[world]):
        got = r['eval']
        for k, v in want['metrics'].items():
            assert abs(got['metrics'][k] - v) <= 1e-6 * max(abs(v), 1e-30), k
        rows = _rows(world, rank)
        for key in ('valid', 'labels'):
            np.testing.assert_array_equal(got[key], want[key][rows])
        for key in ('boxes', 'scores'):
            np.testing.assert_allclose(got[key], want[key][rows], atol=1e-9)
        if rows.start == 0:
            np.testing.assert_allclose(got['heatmaps'], want['heatmaps'], atol=1e-12)


@pytest.mark.parametrize('kind', ['tta', 'folded'])
@pytest.mark.parametrize('world', WORLDS)
def test_predict_equals_one_process(worlds, world, kind):
    """The predict step with the 4-way flip ensemble (each member's maps
    gathered before the un-flip) and on folded weights: each rank's boxes
    those of its rows in one process, the model peers' the same bits."""
    ranks, single = worlds
    want = single[kind]
    for rank, r in enumerate(ranks[world]):
        got, rows = r[kind], _rows(world, rank)
        for key in ('valid', 'labels'):
            np.testing.assert_array_equal(got[key], want[key][rows])
        for key in ('boxes', 'scores'):
            np.testing.assert_allclose(got[key], want[key][rows], atol=1e-9)
        peer = ranks[world][(rank + world // 2) % world][kind]
        for key, v in got.items():
            np.testing.assert_array_equal(v, peer[key])


@pytest.mark.slow
def test_model_parallel2_matches_jax_dp1(tmp_path):
    """The port's counterpart of ``tests/test_parallel/test_dp_equivalence.py::
    test_model_parallel2_matches_dp1``: the L+R+C step of four ranks laid out
    as model_parallel=2 x data_parallel=2 against the JAX step on one device
    (``mm_training_tpu/parallel/dryrun.py::run_one_train_step``, its
    synthesized initial variables carried over by ``state_dict_from_flax``,
    its own flips and dropout masks recorded through a patched
    ``jax.random.bernoulli``), with its tolerances: loss 1e-4, parameters
    5e-4. JAX's model-parallel step on its 8-device CPU mesh is held to its
    one-device step by that test."""
    import jax

    import mm_training_tpu.configs as jcfg
    from mm_training_tpu.data.fake_batch import make_fake_batch
    from mm_training_tpu.parallel.dryrun import _initial_variables, run_one_train_step
    import mm_training_tpu_torch.configs as tcfg
    from mm_training_tpu_torch.models import state_dict_from_flax
    from tests import torch_port_helpers as helpers

    global_batch = 8
    modalities = dict(use_cam=True, use_lidar=True, use_radar=True)
    jc = jcfg.tiny_test_config(batch_size=global_batch, **modalities)
    batch_np = make_fake_batch(jc, batch_size=global_batch, seed=0)
    params, stats = _initial_variables(jcfg.tiny_test_config, modalities)
    draws = {}
    bernoulli = jax.random.bernoulli
    jax.random.bernoulli = helpers._record_bernoulli(draws)
    try:
        p1, m1 = run_one_train_step(jax.devices()[:1], 1, global_batch,
                                    modalities=modalities, batch_np=batch_np)
    finally:
        jax.random.bernoulli = bernoulli
    tc = tcfg.tiny_test_config(batch_size=global_batch, **modalities)
    assert sorted(draws) == list(range(1 + tc.num_sweeps)), sorted(draws)
    state = state_dict_from_flax(params, stats, tc)
    ranks = dryrun.run_one_train_step(
        4, 2, global_batch, device='cpu', modalities=modalities, batch_np=batch_np, state=state,
        draws={'flipped': draws[0], 'dropout': [draws[1 + i].copy()
                                                for i in range(tc.num_sweeps)]},
        all_ranks=True)
    want = {k: t.numpy() for k, t in state_dict_from_flax(p1, stats, tc).items()}
    for r in ranks:
        assert r['metrics'] == ranks[0]['metrics']
        loss = r['metrics']['train_loss']
        assert abs(loss - m1['train_loss']) < 1e-4 * max(1.0, abs(m1['train_loss'])), (
            r['metrics'], m1)
        max_diff = dryrun.max_param_diff(r['params'], want)
        assert max_diff < 5e-4, f'model=2 x data=2 vs JAX dp=1 param max-diff {max_diff}'
    assert sum(float(np.abs(v - state[n].numpy()).sum())
               for n, v in ranks[0]['params'].items()) > 0
