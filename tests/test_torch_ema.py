"""EMA weights of the port (``training/ema.py``, the EMA shadow of
``training/train_step.py`` and the trainer's checkpoints) against the JAX
package's ``training/ema.py`` and ``make_train_step`` with ``use_ema``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mm_training_tpu.training.ema import ema_update as j_ema_update
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu_torch.configs import tiny_test_config
from mm_training_tpu_torch.data import make_fake_batch
from mm_training_tpu_torch.models import BEVDepthLiDAR
from mm_training_tpu_torch.models.bn_fold import BatchNorm2d
from mm_training_tpu_torch.training import (create_train_state, make_eval_step,
                                            make_state_predict_step, make_train_step)
from mm_training_tpu_torch.training.ema import ema_decay_at, ema_update
from mm_training_tpu_torch.training.train_step import _eval_weights
from mm_training_tpu_torch.training.trainer import _load_state, _state_to_dict
from tests.torch_port_helpers import narrow, train_parity_case


def _cfg(**kw):
    """The tiny LiDAR config at the narrow widths of the parity tests."""
    return narrow(tcfg, tiny_test_config(**kw))


@pytest.mark.parametrize('step', [1, 10, 5000])
def test_ema_update_matches_jax_bit_for_bit(step):
    """The same float32 arrays through both updates: the same bits (the
    decay's exp rounds as XLA's does at these steps, asserted first)."""
    rng = np.random.default_rng(step)
    shapes = {'w': (64, 3, 3, 3), 'b': (17,), 'running_var': (5, 7)}
    e = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    j_d = float(0.9999 * (1.0 - jnp.exp(-jnp.asarray(step).astype(jnp.float32) / 2000.0)))
    assert ema_decay_at(step) == j_d
    want = j_ema_update({k: jnp.asarray(v) for k, v in e.items()},
                        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(step), 0.9999)
    shadow = {k: torch.from_numpy(v.copy()) for k, v in e.items()}
    got = ema_update(shadow, {k: torch.from_numpy(v) for k, v in p.items()}, step)
    assert got is shadow
    for k in e:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_ema_update_ramp_and_non_float_entries():
    """The JAX package's cases (tests/test_training/test_ema.py): the decay
    ramps from ~0 to ~0.9999, and a non-floating entry is copied."""
    shadow = {'w': torch.zeros(3), 'n': torch.tensor([1, 2], dtype=torch.int64)}
    new = {'w': torch.ones(3), 'n': torch.tensor([3, 4], dtype=torch.int64)}
    ema_update(shadow, new, 1)
    np.testing.assert_allclose(shadow['w'].numpy(), 1.0, atol=1e-3)
    np.testing.assert_array_equal(shadow['n'].numpy(), [3, 4])
    late = {'w': torch.zeros(3)}
    ema_update(late, {'w': torch.ones(3)}, 100_000)
    np.testing.assert_allclose(late['w'].numpy(), 1e-4, rtol=0.05)


def test_eval_weights_selects_the_shadow():
    cfg = _cfg(use_ema=True, precision='fp32')
    model = BEVDepthLiDAR(cfg, device='cpu')
    state = create_train_state(cfg, model)
    assert set(state.ema) == set(model.state_dict())
    name = 'head.shared_conv.bn.weight'
    state.ema[name].fill_(5.0)
    assert float(_eval_weights(cfg, state)[name][0]) == 5.0
    assert 'head.shared_conv.bn.num_batches_tracked' not in _eval_weights(cfg, state)
    off = cfg.replace(use_ema=False)
    assert float(_eval_weights(off, state)[name][0]) == float(model.state_dict()[name][0].detach())
    bf16 = _eval_weights(cfg.replace(precision='bf16'), state)
    assert bf16[name].dtype == torch.bfloat16 and float(bf16[name][0]) == 5.0


def test_ema_train_step_float64_matches_jax():
    """One float64 ``use_ema`` step of both packages from the same weights
    (``train_parity_case``). The shadow's move is (1 - d) x the step's
    update, so it is held as the update is (``check_train_update``): within
    2.001 (1 - d) lr everywhere, 1e-3 (1 - d) lr where the gradient exceeds
    1e-4 of its tensor's largest; the averaged BN statistics to 1e-5 (as
    ``check_train_bn_stats``). And the port's shadow is exactly its own
    ``ema_update`` of the weights the step stored."""
    case = train_parity_case(use_radar=True, dtype=np.float64, use_ema=True)
    j, p, lr = case['j_ema'], case['p_ema'], case['lr']
    keep = 1.0 - ema_decay_at(1)
    assert set(p) == set(j)
    n_params = n_stats = 0
    for k, want in j.items():
        got = p[k]
        if k.endswith('num_batches_tracked'):
            continue
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)
            n_stats += 1
            continue
        diff = np.abs((got - case['p_old'][k]) - (want - case['j_old'][k]))
        assert diff.max() <= 2.001 * keep * lr, k
        g = np.abs(case['j_mu'][k])
        assert diff[g > 1e-4 * g.max()].max(initial=0) <= 1e-3 * keep * lr, k
        assert np.abs(got - case['p_old'][k]).max() > 0, k
        n_params += 1
    assert n_params > 50 and n_stats > 20
    stored = dict(case['p_new'], **case['p_stats'])
    shadow = {k: torch.from_numpy(np.array(case['p_old'].get(k, case['j_old'].get(k))))
              for k in case['p_new']}
    ema_update(shadow, {k: torch.from_numpy(stored[k]) for k in shadow}, 1)
    for k, t in shadow.items():
        np.testing.assert_array_equal(t.numpy(), p[k], err_msg=k)


def test_checkpoint_round_trip_restores_the_shadow():
    cfg = _cfg(use_ema=True, precision='fp32')
    state = create_train_state(cfg, BEVDepthLiDAR(cfg, device='cpu'), steps_per_epoch=10)
    state, _ = make_train_step(cfg)(state, make_fake_batch(cfg, seed=0))
    tree = _state_to_dict(state, {'epoch': 0})
    assert set(tree['ema']) == set(state.ema)
    fresh = create_train_state(cfg, BEVDepthLiDAR(cfg, device='cpu',
                                                  generator=torch.Generator().manual_seed(9)))
    _load_state(fresh, tree)
    for k, t in state.ema.items():
        assert torch.equal(fresh.ema[k], t), k
    assert not torch.equal(fresh.ema['head.shared_conv.conv.weight'],
                           fresh.model.state_dict()['head.shared_conv.conv.weight'])
    del tree['ema']      # a checkpoint written without use_ema
    with pytest.raises(KeyError, match='no EMA shadow'):
        _load_state(fresh, tree)


def test_bn_cache_never_mixes_the_live_model_and_the_shadow():
    """BatchNorm's s, t cache (``models/bn_fold.py::StateCache``) is keyed on
    the tensors it was made from: eval steps that alternate between the
    live weights and the shadow each get their own statistics' s, t."""
    cfg = _cfg(use_ema=True, precision='fp32')
    state = create_train_state(cfg, BEVDepthLiDAR(cfg, device='cpu'))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for k, t in state.ema.items():
            if k.endswith(('running_mean', 'bias')):
                t.add_(0.3 * torch.randn(t.shape, generator=gen))
    batch = make_fake_batch(cfg, seed=1)
    off = cfg.replace(use_ema=False)
    on_eval, off_eval = make_eval_step(cfg), make_eval_step(off)
    on_pred, off_pred = make_state_predict_step(cfg), make_state_predict_step(off)
    first = {}
    for i in range(3):
        for label, fn in (('ema', on_eval), ('live', off_eval)):
            loss = float(fn(state, batch)[0]['loss'])
            assert first.setdefault(label, loss) == loss, (i, label)
        for label, fn in (('ema_pred', on_pred), ('live_pred', off_pred)):
            scores = fn(state, batch)[1]
            assert torch.equal(first.setdefault(label, scores), scores), (i, label)
    assert first['ema'] != first['live']
    assert not torch.equal(first['ema_pred'], first['live_pred'])
    bn = state.model.head.shared_conv.bn
    assert isinstance(bn, BatchNorm2d)
    s, t = bn.scale_shift()     # the live model's own tensors
    want = bn.bias.float() - bn.running_mean.float() * s
    assert torch.equal(t, want)
