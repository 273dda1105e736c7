"""Data-parallel numerics against the JAX package (slow tier): the port's
step on two gloo ranks equals the JAX step on one device on the same global
batch.

The port's counterpart of ``tests/test_parallel/test_dp_equivalence.py::
test_dp8_matches_dp1``: the same harness on the JAX side
(``parallel/dryrun.py::run_one_train_step`` over one CPU device, its
synthesized initial variables, the global batch of 8 from
``make_fake_batch``, the learning rate of the global batch), and its
tolerances (loss 1e-4, parameters 5e-4). The port's gloo CPU ranks
(``mm_training_tpu_torch/parallel/dryrun.py::run_one_train_step``) start
from those variables carried over by ``state_dict_from_flax``, take 4 rows
each and, with the camera, the JAX step's own flips and dropout masks, recorded through a
patched ``jax.random.bernoulli``."""
import jax
import numpy as np
import pytest

from mm_training_tpu_torch.parallel import dryrun
from tests import torch_port_helpers as helpers

GLOBAL_BATCH = 8
WORLD = 2


@pytest.mark.parametrize('modalities', [
    dict(use_cam=False, use_lidar=True, use_radar=True),
    dict(use_cam=True, use_lidar=True, use_radar=True),
])
@pytest.mark.slow
def test_two_ranks_match_jax_one_device(modalities):
    import mm_training_tpu.configs as jcfg
    from mm_training_tpu.data.fake_batch import make_fake_batch
    from mm_training_tpu.parallel.dryrun import _initial_variables, run_one_train_step
    import mm_training_tpu_torch.configs as tcfg
    from mm_training_tpu_torch.models import state_dict_from_flax

    jc = jcfg.tiny_test_config(batch_size=GLOBAL_BATCH, **modalities)
    batch_np = make_fake_batch(jc, batch_size=GLOBAL_BATCH, seed=0)
    params, stats = _initial_variables(jcfg.tiny_test_config, modalities)
    draws = {}
    bernoulli = jax.random.bernoulli
    jax.random.bernoulli = helpers._record_bernoulli(draws)
    try:
        p1, m1 = run_one_train_step(jax.devices()[:1], 1, GLOBAL_BATCH,
                                    modalities=modalities, batch_np=batch_np)
    finally:
        jax.random.bernoulli = bernoulli
    tc = tcfg.tiny_test_config(batch_size=GLOBAL_BATCH, **modalities)
    state = state_dict_from_flax(params, stats, tc)
    recorded = None
    if modalities['use_cam']:
        assert sorted(draws) == list(range(1 + tc.num_sweeps)), sorted(draws)
        recorded = {'flipped': draws[0], 'dropout': [draws[1 + i].copy()
                                                     for i in range(tc.num_sweeps)]}
    ranks = dryrun.run_one_train_step(WORLD, 1, GLOBAL_BATCH, device='cpu',
                                      modalities=modalities, batch_np=batch_np, state=state,
                                      draws=recorded, all_ranks=True)

    want = {k: t.numpy() for k, t in state_dict_from_flax(p1, stats, tc).items()}
    for r in ranks:
        assert r['metrics'] == ranks[0]['metrics']
        loss = r['metrics']['train_loss']
        assert abs(loss - m1['train_loss']) < 1e-4 * max(1.0, abs(m1['train_loss'])), (
            r['metrics'], m1)
        max_diff = max(float(np.abs(v - want[n]).max()) for n, v in r['params'].items())
        assert max_diff < 5e-4, f'2 ranks vs JAX dp=1 param max-diff {max_diff}'
    assert sum(float(np.abs(v - state[n].numpy()).sum())
               for n, v in ranks[0]['params'].items()) > 0
