"""The bilinear resize between a LiDAR BEV and a camera BEV of another shape
(``ops/warp.py::resize_bilinear``; JAX ``ops/warp.py:114-118``,
``models/bev_depth.py:91-92``): ``jax.image.resize(..., 'bilinear')``
antialiases when it shrinks, and the port's ``F.interpolate(antialias=True)``
follows it. Held against JAX on a shrink and a growth in fp32 (1e-5) and in
bf16 (the port resizes in float32 and rounds once), its gradient against
``jax.vjp``, and a tiny L+C model whose LiDAR grid is twice as fine as its
camera grid: its fusion input is the camera BEV beside the resized LiDAR
BEV, and (slow tier: one JAX model compile) its boxes are the JAX
model's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_training_tpu.ops.warp import resize_bilinear as j_resize
from mm_training_tpu_torch.ops.warp import resize_bilinear
from tests import torch_port_helpers as helpers

SHAPES = {'shrink': (32, 48), 'grow': (128, 200)}


def _map(seed=0):
    return np.random.default_rng(seed).standard_normal((2, 64, 128, 5)).astype(np.float32)


@pytest.mark.parametrize('kind', sorted(SHAPES))
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_resize_matches_jax(kind, dtype):
    """The port's resize of an NCHW map equals JAX's of the NHWC one: in
    fp32 within 1e-5. In bf16 the port's map is bf16 too, within one ulp of
    each entry of the fp32 resize of the same bf16 map (it rounds once), and
    within one bf16 ulp of the map's largest entry of JAX's bf16 resize,
    which rounds along the way (JAX's own distance to the fp32 resize: up to
    0.017 on this map of largest entry 4.7, against the port's 0.0078)."""
    x = _map()
    out_hw = SHAPES[kind]
    jx = jnp.asarray(x).astype(jnp.bfloat16) if dtype == 'bfloat16' else jnp.asarray(x)
    want = np.asarray(j_resize(jx, out_hw).astype(jnp.float32))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    got = resize_bilinear(tx, out_hw)
    assert got.dtype == tx.dtype and got.shape == (2, 5, *out_hw)
    got = got.float().permute(0, 2, 3, 1).numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    exact = np.asarray(j_resize(jx.astype(jnp.float32), out_hw))

    def ulp(v):
        return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)
    assert (np.abs(got - exact) <= ulp(exact)).all()
    assert np.abs(got - want).max() <= ulp(np.abs(x).max())


@pytest.mark.parametrize('kind', sorted(SHAPES))
def test_resize_gradient_matches_jax(kind):
    """d(resize)^T on a random cotangent against ``jax.vjp``, fp32, 1e-5."""
    x = _map(1)
    out_hw = SHAPES[kind]
    ct = np.random.default_rng(2).standard_normal((2, *out_hw, 5)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: j_resize(a, out_hw), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    resize_bilinear(tx, out_hw).backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5,
                               atol=1e-5)


def _unequal_grids(cfgmod):
    """Tiny L+C (narrow widths, fp32) with 0.1 m voxels: the LiDAR BEV is
    [32, 64] and the camera BEV [16, 32]."""
    return helpers.narrow_cam(cfgmod, cfgmod.tiny_test_config(
        use_cam=True, use_radar=False, voxel_size=(0.1, 0.1, 8.0)))


def test_model_fuses_the_camera_bev_with_the_resized_lidar_bev():
    """On the unequal grids the fuse layer's input is the BDA-warped camera
    BEV, then the LiDAR BEV resized to the camera grid (the order and the
    resize of the JAX model, ``models/bev_depth.py:91-92``), bit for bit."""
    import mm_training_tpu_torch.configs as tcfg
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.ops.warp import bda_bev_warp
    from mm_training_tpu_torch.training import make_predict_step

    tc = _unequal_grids(tcfg)
    assert tc.out_shape == (256, 512) and tc.get_backbone_conf().bev_hw == (16, 32)
    model = BEVDepthLiDAR(tc, device='cpu', generator=torch.Generator().manual_seed(5))
    seen = {}
    hooks = [model.backbone.register_forward_hook(lambda m, i, o: seen.update(cam=o[0])),
             model.lidar_encoder.register_forward_hook(lambda m, i, o: seen.update(lidar=o)),
             model.bev_fuse.register_forward_pre_hook(lambda m, i: seen.update(fused=i[0]))]
    batch = make_fake_batch(tc, seed=3)
    make_predict_step(tc, model)(batch)
    for h in hooks:
        h.remove()
    assert seen['lidar'].shape[2:] == (32, 64) and seen['fused'].shape[2:] == (16, 32)
    cam = bda_bev_warp(seen['cam'], torch.as_tensor(batch['bda_mat'])).permute(0, 3, 1, 2)
    want = torch.cat([cam, resize_bilinear(seen['lidar'], (16, 32))], dim=1)
    assert torch.equal(seen['fused'], want)


@pytest.mark.slow
def test_model_with_unequal_grids_matches_jax():
    """On the unequal grids the LiDAR map is shrunk before the fusion, with
    the antialias: the predict step's boxes equal the JAX package's
    (``torch_port_helpers._compare_boxes``)."""
    import mm_training_tpu.configs as jcfg
    from mm_training_tpu.data.fake_batch import make_fake_batch as j_fake_batch
    from mm_training_tpu.models import BEVDepthLiDAR as JModel
    from mm_training_tpu.training.train_step import TrainState
    from mm_training_tpu.training.train_step import make_predict_step as j_predict
    import mm_training_tpu_torch.configs as tcfg
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.models import BEVDepthLiDAR, state_dict_from_flax
    from mm_training_tpu_torch.training import make_predict_step

    jc, tc = _unequal_grids(jcfg), _unequal_grids(tcfg)
    assert tc.out_shape == (256, 512) and tc.get_backbone_conf().bev_hw == (16, 32)
    jbatch = j_fake_batch(jc, seed=3)
    batch = make_fake_batch(tc, seed=3)
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
    jm = JModel(jc)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    flipped = jnp.zeros((2 * jc.num_cameras,), bool)
    v = helpers.random_variables(jm.init, dict(jb, flipped=flipped), seed=4)
    want = [np.asarray(a) for a in j_predict(jc, jm)(
        TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                   batch_stats=v['batch_stats'], opt_state=None), jb)]
    model = BEVDepthLiDAR(tc, device='cpu')
    model.load_state_dict(state_dict_from_flax(v['params'], v['batch_stats'], tc))
    seen = []
    hook = model.lidar_encoder.register_forward_hook(lambda m, i, o: seen.append(o.shape))
    got = [a.numpy() for a in make_predict_step(tc, model)(batch)]
    hook.remove()
    assert [tuple(s[2:]) for s in seen] == [(32, 64)]
    helpers._compare_boxes(got, want)
