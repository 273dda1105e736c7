"""The port's modules against the JAX package's, fp32, on the CPU.

Each flax module gets random variables (every kernel, bias and BN
statistic, from numpy with a seed); ``mm_training_tpu_torch.models.weights``
carries them into the port module; both run on the same inputs and must
agree within 1e-4 (the repo's module tolerance,
tests/test_models/test_activation_parity.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mm_training_tpu.configs as jcfg
from mm_training_tpu.data.fake_batch import make_fake_batch
from mm_training_tpu.models.centerpoint_head import BEVDepthHead as JHead
from mm_training_tpu.models.lidar_encoder import LidarBEVEncoder as JEncoder
from mm_training_tpu.models.resnet import ResNet as JResNet
from mm_training_tpu.models.resnet import space_to_depth_2x2 as j_s2d
from mm_training_tpu.models.second_fpn import SECONDFPN as JSECONDFPN
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu_torch.models import (BEVDepthHead, LidarBEVEncoder, ResNet,
                                          SECONDFPN, space_to_depth_2x2)
from mm_training_tpu_torch.models import weights
from tests.torch_port_helpers import narrow, nchw, nhwc, random_variables

TOL = dict(rtol=1e-4, atol=1e-4)


def _load(module, state_dict):
    module.load_state_dict(state_dict, strict=True)
    return module.eval()


def _apply(module, variables, *args):
    return jax.jit(functools.partial(module.apply, train=False))(variables, *args)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_resnet18_trunk():
    kw = dict(num_stages=3, strides=(1, 2, 2), out_indices=(0, 1, 2))
    jm = JResNet(depth=18, base_channels=16, **kw)
    x = _rand((2, 32, 48, 24), 0)
    v = random_variables(jm.init, jnp.asarray(x), seed=1)
    want = _apply(jm, v, jnp.asarray(x))
    tm = _load(ResNet(18, in_channels=24, base_channels=16, **kw),
               weights.resnet_state_dict(v['params'], v['batch_stats'], 3))
    with torch.no_grad():
        got = tm(nchw(x))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), **TOL)


def test_second_fpn_transpose_and_strided_levels():
    in_ch, out_ch, strides = (6, 12, 20), (8, 8, 8), (0.5, 2, 4)
    jm = JSECONDFPN(out_channels=out_ch, upsample_strides=strides)
    feats = [_rand((2, 32, 48, 6), 2), _rand((2, 8, 12, 12), 3),
             _rand((2, 4, 6, 20), 4)]
    jfeats = [jnp.asarray(f) for f in feats]
    v = random_variables(jm.init, jfeats, seed=5)
    want = np.asarray(_apply(jm, v, jfeats))
    tm = _load(SECONDFPN(in_ch, out_ch, strides),
               weights.second_fpn_state_dict(v['params'], v['batch_stats'], strides))
    with torch.no_grad():
        got = nhwc(tm([nchw(f) for f in feats]))
    np.testing.assert_allclose(got, want, **TOL)


def test_space_to_depth_matches_jax():
    x = _rand((2, 4, 6, 3), 6)
    np.testing.assert_array_equal(space_to_depth_2x2(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_s2d(jnp.asarray(x))))


@pytest.mark.parametrize('s2d', [True, False])
def test_lidar_encoder(s2d):
    jc = jcfg.tiny_test_config(use_cam=False)
    tc = tcfg.tiny_test_config(use_cam=False)
    jconf = dataclasses.replace(jc.get_lidar_conf(), space_to_depth=s2d)
    tconf = dataclasses.replace(tc.get_lidar_conf(), space_to_depth=s2d)
    geo = dict(pc_range=jc.point_cloud_range, voxel_size=jc.voxel_size,
               grid_hw=jc.out_shape)
    jm = JEncoder(jconf, **geo)
    batch = make_fake_batch(jc, seed=7, points_fill=0.8)
    pts, mask = batch['points'], batch['point_mask']
    v = random_variables(jm.init, jnp.asarray(pts), jnp.asarray(mask), seed=8)
    want = np.asarray(_apply(jm, v, jnp.asarray(pts), jnp.asarray(mask)))
    tm = _load(LidarBEVEncoder(tconf, **geo),
               weights.lidar_encoder_state_dict(v['params'], v['batch_stats'],
                                                tconf))
    with torch.no_grad():
        got = nhwc(tm(torch.from_numpy(pts), torch.from_numpy(mask)))
    assert got.shape == (2, 16, 32, 256)
    np.testing.assert_allclose(got, want, **TOL)


def test_bev_depth_head():
    """The tiny config's head (4 tasks x 6 branches, /4 stem, x8/16/32
    deconvs) at narrow trunk and neck widths."""
    jm = JHead(narrow(jcfg, jcfg.tiny_test_config(use_cam=False)).get_head_conf())
    hconf = narrow(tcfg, tcfg.tiny_test_config(use_cam=False)).get_head_conf()
    x = _rand((1, 16, 32, 64), 9)
    v = random_variables(jm.init, jnp.asarray(x), seed=10)
    want = _apply(jm, v, jnp.asarray(x))
    tm = _load(BEVDepthHead(hconf),
               weights.bev_head_state_dict(v['params'], v['batch_stats'], hconf))
    with torch.no_grad():
        got = tm(nchw(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in w:
            assert g[name].shape == (1, 32, 64, w[name].shape[-1])
            np.testing.assert_allclose(g[name].numpy(), np.asarray(w[name]),
                                       **TOL, err_msg=name)
