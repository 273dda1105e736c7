"""The port's camera-branch modules against the JAX package's, fp32, on the
CPU.

Each flax module gets random variables (every kernel, bias and BN statistic
from numpy with a seed, so the DCN's offset conv is random too and its taps
leave the pixel grid); ``mm_training_tpu_torch.models.weights`` carries them
into the port module; both run on the same inputs and must agree within
1e-4 of the map's scale (the repo's module tolerance,
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
from mm_training_tpu.models.depth_net import ASPP as JASPP
from mm_training_tpu.models.depth_net import DepthNet as JDepthNet
from mm_training_tpu.models.fusion import BEVFuseLayer as JFuse
from mm_training_tpu.models.lss_fpn import LSSFPN as JLSSFPN
from mm_training_tpu.models.resnet import ResNet as JResNet
from mm_training_tpu.models.second_fpn import SECONDFPN as JSECONDFPN
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu_torch.models import ResNet, SECONDFPN, weights
from mm_training_tpu_torch.models.depth_net import (ASPP, AtrousConv2d, DepthNet,
                                                    phase_split_conv3x3)
from mm_training_tpu_torch.models.fusion import BEVFuseLayer
from mm_training_tpu_torch.models.lss_fpn import LSSFPN
from tests.torch_port_helpers import nchw, nhwc, random_variables


def _close(got, want, tol=1e-4):
    """Within ``tol`` of the map's largest magnitude."""
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _load(module, state_dict):
    module.load_state_dict(state_dict, strict=True)
    return module.eval()


def _apply(module, variables, *args, **kw):
    return jax.jit(functools.partial(module.apply, train=False, **kw))(variables, *args)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def test_resnet50_s2d_stem():
    """ResNet-50 (Bottleneck, four stages) at base width 8 with the JAX
    space-to-depth stem, carried over as the reference's 7x7 conv1."""
    jm = JResNet(depth=50, base_channels=8, stem_s2d=True)
    x = _rand((2, 64, 96, 3), 0)
    v = random_variables(jm.init, jnp.asarray(x), seed=1)
    want = _apply(jm, v, jnp.asarray(x))
    tm = _load(ResNet(50, in_channels=3, base_channels=8),
               weights.resnet_state_dict(v['params'], v['batch_stats'], 4, depth=50,
                                         stem_s2d=True))
    with torch.no_grad():
        got = tm(nchw(x))
    assert [g.shape[1] for g in got] == [32, 64, 128, 256]
    for g, w in zip(got, want):
        _close(nhwc(g), w)


def test_image_neck_strides_below_and_at_one():
    """The image neck's strides (0.25, 0.5, 1, 2): strided convs, the
    stride-1 ConvTranspose against the JAX ``Upsample`` at s = 1, and a
    x2 upsample, concatenated at /16."""
    in_ch, out_ch, strides = (8, 16, 24, 32), (8, 8, 8, 8), (0.25, 0.5, 1, 2)
    jm = JSECONDFPN(out_channels=out_ch, upsample_strides=strides)
    feats = [_rand((2, 16 * 4 // 2 ** i, 24 * 4 // 2 ** i, c), 2 + i)
             for i, c in enumerate(in_ch)]
    jfeats = [jnp.asarray(f) for f in feats]
    v = random_variables(jm.init, jfeats, seed=5)
    want = _apply(jm, v, jfeats)
    tm = _load(SECONDFPN(in_ch, out_ch, strides),
               weights.second_fpn_state_dict(v['params'], v['batch_stats'], strides))
    with torch.no_grad():
        got = nhwc(tm([nchw(f) for f in feats]))
    assert got.shape == (2, 16, 24, 32)
    _close(got, want)


def test_aspp():
    """ASPP: 1x1 and dilated 3x3 (6, 12, 18) branches, the global-mean
    branch broadcast back, the 1x1 merge; dropout off in eval."""
    jm = JASPP(mid_channels=16)
    x = _rand((2, 11, 20, 24), 6)
    v = random_variables(jm.init, jnp.asarray(x), seed=7)
    want = _apply(jm, v, jnp.asarray(x))
    tm = _load(ASPP(24, 16), weights.aspp_state_dict(v['params'], v['batch_stats']))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    _close(got, want)


@pytest.mark.parametrize('shape,dilation', [((2, 8, 44, 80), 12), ((2, 8, 44, 80), 18),
                                            ((1, 4, 5, 7), 12), ((1, 3, 9, 13), 2)])
def test_phase_split_conv_equals_the_dilated_conv(shape, dilation):
    """ASPP's wide dilations run as a 3x3 conv over phase sub-images: the
    same map as the dilated conv with its zero padding (float64), also on
    maps smaller than the dilation, and channels_last out."""
    x = torch.from_numpy(_rand(shape, 16)).double().contiguous(
        memory_format=torch.channels_last)
    w = torch.from_numpy(_rand((5, shape[1], 3, 3), 17)).double()
    got = phase_split_conv3x3(x, w, dilation)
    want = torch.nn.functional.conv2d(x, w, None, 1, dilation, dilation)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    conv = AtrousConv2d(shape[1], 5, dilation)
    with torch.no_grad():
        conv.weight.copy_(w)
        np.testing.assert_allclose(conv.double()(x).numpy(), want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize('use_dcn', [True, False])
def test_depth_net_with_random_offsets(use_dcn):
    """DepthNet (reduce conv, context 1x1, 3 BasicBlocks, ASPP, DCN, depth
    1x1) at mid width 32; the random offset conv moves the taps by a few
    pixels, some outside the map."""
    jm = JDepthNet(mid_channels=32, context_channels=80, depth_channels=50, use_dcn=use_dcn)
    x = _rand((2, 8, 16, 48), 8)
    v = random_variables(jm.init, jnp.asarray(x), seed=9)
    if use_dcn:   # offsets of a few pixels: scale the offset conv up
        off = v['params']['dcn']['conv_offset']
        off['kernel'] = off['kernel'] * 8.0
    want = _apply(jm, v, jnp.asarray(x))
    tm = _load(DepthNet(48, 32, 80, 50, use_dcn=use_dcn),
               weights.depth_net_state_dict(v['params'], v['batch_stats']))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert got.shape == (2, 8, 16, 130)
    _close(got, want)


def _backbone_conf(cfgmod):
    """The tiny camera geometry (2 cameras of 64 x 128, 50 bins) with an
    image ResNet-10 and DepthNet mid width 32."""
    bb = cfgmod.tiny_test_config(use_cam=True).get_backbone_conf()
    return dataclasses.replace(
        bb, img_backbone_conf=cfgmod.ImageBackboneConf(depth=10),
        depth_net_conf=cfgmod.DepthNetConf(in_channels=512, mid_channels=32))


@pytest.mark.parametrize('sweeps', [1, 2])
def test_lss_fpn(sweeps):
    """LSSFPN end to end (backbone, neck, DepthNet, softmax, the hflip undo
    with one flipped image, the oracle on one sweep and the factorized
    splat summed over cameras) against the JAX module; sweeps concatenate
    on channels."""
    jc = jcfg.tiny_test_config(use_cam=True, num_sweeps=sweeps)
    batch = make_fake_batch(jc, seed=10)
    imgs = _rand(batch['imgs'].shape, 11)
    s2e, intr = batch['sensor2ego'], batch['intrin']
    flipped = np.zeros(2 * sweeps * 2, bool)
    flipped[1] = True
    jm = JLSSFPN(_backbone_conf(jcfg))
    args = [jnp.asarray(a) for a in (imgs, s2e, intr, flipped)]
    v = random_variables(jm.init, *args, seed=12)
    v['params']['depth_net']['dcn']['conv_offset']['kernel'] *= 8.0
    for oracle in (None, np.eye(51, dtype=np.float32)[
            np.random.default_rng(13).integers(0, 50, (4, 4, 8))]):
        jo = None if oracle is None else jnp.asarray(oracle)
        want_bev, want_depth = _apply(jm, v, *args, jo)
        tm = _load(LSSFPN(_backbone_conf(tcfg)), _lss_state_dict(v))
        with torch.no_grad():
            bev, depth = tm(*(torch.from_numpy(a) for a in (imgs, s2e, intr, flipped)),
                            None if oracle is None else torch.from_numpy(oracle))
        assert bev.shape == (2, 16, 32, 80 * sweeps)
        _close(bev.numpy(), want_bev)
        _close(depth.permute(0, 2, 3, 1).numpy(), want_depth)


def _lss_state_dict(v):
    p, s = v['params'], v['batch_stats']
    out = weights.resnet_state_dict(p['img_backbone'], s['img_backbone'], 4,
                                    prefix='img_backbone.', depth=10, stem_s2d=True)
    out.update(weights.second_fpn_state_dict(p['img_neck'], s['img_neck'],
                                             (0.25, 0.5, 1, 2), prefix='img_neck.'))
    out.update(weights.depth_net_state_dict(p['depth_net'], s['depth_net'],
                                            prefix='depth_net.'))
    return out


def test_bev_fuse_layer():
    """3x3 conv (24 -> 40 channels, as the flax conv emits the config's
    count), global mean, 1x1 conv, sigmoid gate."""
    jm = JFuse(in_channels=40)
    x = _rand((2, 16, 32, 24), 14)
    v = random_variables(jm.init, jnp.asarray(x), seed=15)
    want = jax.jit(jm.apply)({'params': v['params']}, jnp.asarray(x))
    tm = _load(BEVFuseLayer(24, 40), weights.fuse_layer_state_dict(v['params']))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    _close(got, want)
