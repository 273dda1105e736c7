"""Deploy-time conv+BN folding of the port (``models/bn_fold.py``:
``conv_bn_pairs``, ``fold_conv_bn``, ``fold_model``, ``fold_state``,
``FoldedBN``) against the JAX package's ``fold_conv_bn``, and the folded
forward and predict against the unfolded ones."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mm_training_tpu.configs as jcfg
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu.data.fake_batch import make_fake_batch as j_fake_batch
from mm_training_tpu.models import BEVDepthLiDAR as JModel
from mm_training_tpu.models.bn_fold import fold_conv_bn as j_fold_conv_bn
from mm_training_tpu_torch.data import make_fake_batch
from mm_training_tpu_torch.models import BEVDepthLiDAR, state_dict_from_flax
from mm_training_tpu_torch.models.bn_fold import (BatchNorm2d, FoldedBN, conv_bn_pairs,
                                                  fold_conv_bn, fold_model, fold_state)
from mm_training_tpu_torch.ops import affine_act
from mm_training_tpu_torch.training import (camera_inputs, create_train_state, make_predict_step,
                                            make_train_step)
from tests.torch_port_helpers import narrow, narrow_cam, random_variables


def _unfold_like(folded, orig_p, orig_s):
    """The JAX-folded trees in the unfolded form the weight carry reads: a
    folded BN scope ({'bias'} where the original had a scale) gets a unit
    scale and unit statistics back; everything else as folded."""
    if not isinstance(folded, dict):
        return folded, orig_s
    p, s = {}, {}
    for k, v in folded.items():
        o = orig_p[k]
        if isinstance(o, dict) and 'scale' in o and set(v) == {'bias'}:
            p[k] = {'scale': np.ones_like(o['scale']), 'bias': v['bias']}
            s[k] = {'mean': np.zeros_like(o['scale']), 'var': np.ones_like(o['scale'])}
        elif isinstance(v, dict):
            p[k], sub = _unfold_like(v, o, (orig_s or {}).get(k, {}))
            if sub:
                s[k] = sub
        else:
            p[k] = v
    return p, s


@pytest.mark.parametrize('camera', [False, True], ids=['lidar_radar', 'camera'])
def test_fold_conv_bn_matches_jax(camera):
    """Random flax variables (every BN scale and statistic random) folded by
    both packages: the port's folded conv weights and biases within 1e-6
    relative (of each tensor's largest) of the JAX-folded kernels and
    biases, carried over by the same layout rules; every BN of the port
    pairs with its conv, as every JAX BN scope of these models folds."""
    widen = narrow_cam if camera else narrow
    kw = dict(use_cam=camera, use_radar=True)
    jc, tc = widen(jcfg, jcfg.tiny_test_config(**kw)), widen(tcfg, tcfg.tiny_test_config(**kw))
    jm = JModel(jc)
    jb = {k: jnp.asarray(v) for k, v in j_fake_batch(jc, seed=3).items()}
    b, s, n = jb['imgs'].shape[:3]
    v = random_variables(jm.init, dict(jb, flipped=jnp.zeros((b * s * n,), bool)), seed=4)
    p2, s2, n_folded = j_fold_conv_bn(v['params'], v['batch_stats'])
    assert not jax.tree_util.tree_leaves(s2)       # the dense models fold fully
    up, us = _unfold_like(jax.tree_util.tree_map(np.asarray, p2), v['params'], v['batch_stats'])
    want = state_dict_from_flax(up, us, tc)

    model = BEVDepthLiDAR(tc, device='cpu')
    model.load_state_dict(state_dict_from_flax(v['params'], v['batch_stats'], tc))
    pairs = conv_bn_pairs(model)
    assert len(pairs) == n_folded == sum(isinstance(m, BatchNorm2d) for m in model.modules())
    got = fold_conv_bn(model.state_dict(), pairs)
    for conv, bn, _, _ in pairs:
        for key in (f'{conv}.weight', f'{bn}.bias'):
            w = want[key].numpy()
            err = np.abs(got[key].numpy() - w).max() / np.abs(w).max()
            assert err <= 1e-6, (key, err)
        assert f'{bn}.running_mean' not in got and f'{bn}.weight' not in got
        if f'{conv}.bias' in got:
            assert not got[f'{conv}.bias'].any()


def _randomize_bn(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                c = m.num_features
                m.weight.copy_(1 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.2 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.5 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))


@pytest.mark.parametrize('camera', [False, True], ids=['lidar_radar', 'camera'])
def test_folded_forward_matches_eval_bn(camera, monkeypatch):
    """The fp32 tiny config with random BN statistics: the folded forward's
    maps (and depth) within 1e-4 of each map's scale of the unfolded eval
    forward; kernel A runs at every folded tail, as often as at the BN
    tails, each time with a unit scale."""
    cfg = tcfg.tiny_test_config(use_cam=camera, precision='fp32')
    model = BEVDepthLiDAR(cfg, device='cpu')
    _randomize_bn(model, 1)
    batch = make_fake_batch(cfg, seed=0)
    pts, mask = torch.from_numpy(batch['points']), torch.from_numpy(batch['point_mask'])
    cam = camera_inputs(cfg, batch, 'cpu', pts, mask) if camera else {}
    scales = []
    plain = affine_act.affine_act

    def recording(x, scale, *a, **k):
        scales.append(scale)
        return plain(x, scale, *a, **k)
    monkeypatch.setattr(affine_act, 'affine_act', recording)
    with torch.no_grad():
        ref, ref_depth = model(pts, mask, **cam, return_depth=True)
        n_bn = len(scales)
        folded = copy.deepcopy(model)
        fold_model(folded)
        del scales[:]
        got, got_depth = folded(pts, mask, **cam, return_depth=True)
    assert len(scales) == n_bn > 20 and all(bool((s == 1).all()) for s in scales)
    assert not any(isinstance(m, BatchNorm2d) for m in folded.modules())
    assert sum(isinstance(m, FoldedBN) for m in folded.modules()) == len(conv_bn_pairs(model))
    for r, g in zip(ref, got):
        for k in r:
            err = (g[k] - r[k]).abs().max() / r[k].abs().max().clamp_min(1.0)
            assert err <= 1e-4, (k, float(err))
    if camera:
        assert (got_depth - ref_depth).abs().max() <= 1e-4
    with pytest.raises(ValueError, match='no conv.BN pairs'):
        fold_model(folded)                   # already folded


def test_folded_predict_matches_unfolded_and_training_raises():
    """The predict step on folded weights decodes the boxes of the unfolded
    one (boxes and scores within 2e-3, labels and valid equal: the JAX CLI
    test's tolerances); a train step on the folded state raises ValueError,
    while the unfolded model, untouched by the fold of its copy, trains; the
    EMA shadow folds with the model."""
    cfg = tcfg.tiny_test_config(use_cam=False, precision='fp32', use_ema=True)
    model = BEVDepthLiDAR(cfg, device='cpu')
    _randomize_bn(model, 2)
    batch = make_fake_batch(cfg, seed=0)
    ref = [t.numpy() for t in make_predict_step(cfg, model)(batch)]
    state = create_train_state(cfg, copy.deepcopy(model))
    state = fold_state(state)
    assert set(state.ema) == set(state.model.state_dict())
    got = [t.numpy() for t in make_predict_step(cfg, state.model)(batch)]
    np.testing.assert_allclose(got[0], ref[0], atol=2e-3)
    np.testing.assert_allclose(got[1], ref[1], atol=2e-3)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])
    assert ref[3].sum() > 50
    with pytest.raises(ValueError, match='inference-only'):
        make_train_step(cfg)(state, batch)
    assert any(isinstance(m, BatchNorm2d) for m in model.modules())
    unfolded = create_train_state(cfg, model, steps_per_epoch=10)
    unfolded, metrics = make_train_step(cfg)(unfolded, batch)
    assert torch.isfinite(metrics['train_loss'])
