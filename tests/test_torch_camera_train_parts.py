"""Parts of the port's camera train step against the JAX package on the
CPU: ASPP's dropout with a given keep mask against flax's ``nn.Dropout``
fed the same mask, the running statistics of a BatchNorm that one step runs
twice (a camera sweep after the key frame) against flax's in bf16, the
step's own random draws, and the training inputs (the flip of images and
labels, the unflipped depth oracle) against JAX ``_prepare_camera_inputs``.
"""
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mm_training_tpu.configs as jcfg
from mm_training_tpu.training import train_step as j_steps
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu_torch.data import make_fake_batch
from mm_training_tpu_torch.models.bn_fold import BatchNorm2d, begin_step
from mm_training_tpu_torch.models.depth_net import Dropout
from mm_training_tpu_torch.training import camera_train_inputs, draw_train_randoms


def test_dropout_with_a_mask_matches_flax():
    """``where(keep, x / 0.5, 0)`` in train mode with flax's own mask (flax
    draws it, the port is handed it), the identity in eval; a train-mode
    call without a mask of the input's shape raises."""
    from tests.torch_port_helpers import _record_bernoulli
    x = np.random.default_rng(50).normal(size=(2, 3, 4, 5)).astype(np.float32)
    drop = fnn.Dropout(0.5, deterministic=False)
    draws = {}
    bernoulli = jax.random.bernoulli
    jax.random.bernoulli = _record_bernoulli(draws)       # flax's own draw, recorded
    try:
        want = np.asarray(drop.apply({}, jnp.asarray(x), rngs={'dropout': jax.random.PRNGKey(3)}))
    finally:
        jax.random.bernoulli = bernoulli
    keep = draws[0].copy()
    m = Dropout(0.5).train()
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(keep).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert 0.3 < keep.mean() < 0.7
    with pytest.raises(ValueError, match='keep mask'):
        m(torch.from_numpy(x))
    assert torch.equal(m.eval()(torch.from_numpy(x)), torch.from_numpy(x))


def test_bn_statistics_of_two_calls_in_one_step_match_flax_bf16():
    """The JAX bf16 step casts the statistics to bf16 once, then flax's
    BatchNorm updates them at each call (``0.9 * old`` in the old dtype,
    0.9 itself rounded to it, plus ``0.1 * batch`` in float32): a second
    call in the same step (a camera sweep after the key frame) starts from
    the float32 result of the first. The port rounds the old statistics
    once a step (``begin_step``); two steps round twice. To 1e-6 (bf16
    inputs, float32 statistics)."""
    rng = np.random.default_rng(51)
    xs = [rng.normal(0.5, 2.0, (2, 4, 5, 8)).astype(np.float32) for _ in range(4)]
    mean0 = rng.normal(0, 0.5, (8,)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, (8,)).astype(np.float32)

    class Twice(fnn.Module):
        @fnn.compact
        def __call__(self, a, b):
            bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                               dtype=a.dtype)
            return bn(a), bn(b)
    stats = {'mean': jnp.asarray(mean0), 'var': jnp.asarray(var0)}
    params = {'scale': jnp.ones(8, jnp.bfloat16), 'bias': jnp.zeros(8, jnp.bfloat16)}
    for a, b in ((xs[0], xs[1]), (xs[2], xs[3])):           # two steps of two calls
        bf = jax.tree_util.tree_map(lambda t: t.astype(jnp.bfloat16), stats)
        _, upd = Twice().apply({'params': {'BatchNorm_0': params}, 'batch_stats':
                                {'BatchNorm_0': bf}},
                               jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                               mutable=['batch_stats'])
        stats = jax.tree_util.tree_map(lambda t: t.astype(jnp.float32),
                                       upd['batch_stats']['BatchNorm_0'])

    bn = BatchNorm2d(8).train()
    bn.running_mean.copy_(torch.from_numpy(mean0))
    bn.running_var.copy_(torch.from_numpy(var0))
    bn = bn.to(torch.bfloat16)
    bn.running_mean.data, bn.running_var.data = (bn.running_mean.float(),
                                                 bn.running_var.float())
    with torch.no_grad():
        for a, b in ((xs[0], xs[1]), (xs[2], xs[3])):
            begin_step(bn)
            for x in (a, b):
                bn(torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2))
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats['mean']), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats['var']), atol=1e-6)


def test_step_draws_shapes_layout_and_rates():
    """``draw_train_randoms``: [B*S*N] flips and one [B*N, mid, fH, fW]
    keep mask a sweep in the activations' channels-last memory, about half
    of each set, the same draws again from the same seed."""
    cfg = tcfg.tiny_test_config(use_cam=True, num_sweeps=2)
    shape = (2, 2, 2, 64, 128, 3)
    draws = [draw_train_randoms(cfg, shape, torch.Generator().manual_seed(7), 'cpu')
             for _ in range(2)]
    d = draws[0]
    bb = cfg.get_backbone_conf()
    assert d['flipped'].shape == (8,) and d['flipped'].dtype == torch.bool
    assert len(d['dropout']) == 2
    for keep in d['dropout']:
        assert keep.shape == (4, bb.depth_net_conf.mid_channels, *bb.feat_hw)
        assert keep.is_contiguous(memory_format=torch.channels_last)
        assert 0.45 < keep.float().mean() < 0.55
    assert not torch.equal(d['dropout'][0], d['dropout'][1])
    assert torch.equal(draws[1]['flipped'], d['flipped'])
    assert all(torch.equal(a, b) for a, b in zip(draws[1]['dropout'], d['dropout']))


@pytest.mark.parametrize('depth_gt', [False, True])
def test_camera_train_inputs_match_jax(depth_gt):
    """The train half of JAX ``_prepare_camera_inputs`` on the same batch
    (a rotated BEV augmentation; labels from K6 on the un-rotated points, or
    from a precomputed ``depth_gt``) and the same flips: the images flipped
    where marked (bit for bit with eager JAX's normalisation), the loss's
    labels the key frame's flipped ones, the oracle its unflipped ones."""
    from mm_training_tpu_torch.data import random_bda_matrices
    kw = dict(use_cam=True, num_sweeps=2)
    jc, tc = jcfg.tiny_test_config(**kw), tcfg.tiny_test_config(**kw)
    batch = make_fake_batch(tc, seed=9)
    batch['bda_mat'] = random_bda_matrices(2, seed=10)
    if depth_gt:
        bb = tc.get_backbone_conf()
        batch['depth_gt'] = np.random.default_rng(11).uniform(
            0, 40, (2, tc.num_cameras, *bb.feat_hw)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model_batch, loss_labels, oracle = j_steps._prepare_camera_inputs(jc, jb, key, True)
    flips = np.asarray(model_batch['flipped'])
    assert flips.shape == (8,) and flips.any() and not flips.all()
    cam, labels = camera_train_inputs(tc, batch, 'cpu', torch.from_numpy(flips))
    np.testing.assert_array_equal(cam['imgs'].numpy(), np.asarray(model_batch['imgs']))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(loss_labels))
    np.testing.assert_array_equal(cam['depth_oracle'].numpy(), np.asarray(oracle))
    assert labels.sum() > 0
    key_flips = flips.reshape(2, 2, 2)[:, 0].reshape(-1)
    assert not np.array_equal(labels.numpy()[key_flips], cam['depth_oracle'].numpy()[key_flips])
    off = dataclasses.replace(tc, use_depth_loss=False)
    assert camera_train_inputs(off, batch, 'cpu', torch.from_numpy(flips))[0]['depth_oracle'] is None
