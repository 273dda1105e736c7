"""The port's ``voxel_pooling`` and ``lift_splat_matrix`` (plain PyTorch,
on no path) against the JAX package's on the cases of
``tests/test_ops/test_voxel_pooling.py``: the same seeded inputs, outputs
within 1e-5 in float32, ``voxel_pooling``'s gradient against ``jax.vjp``."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

# the packages' ``ops`` export functions of the modules' names
jvp = importlib.import_module('mm_training_tpu.ops.voxel_pooling')
tvp = importlib.import_module('mm_training_tpu_torch.ops.voxel_pooling')


def _pooling_case(seed=0, b=2, n=500, c=8):
    rng = np.random.default_rng(seed)
    geom = rng.integers(-3, 18, size=(b, n, 3)).astype(np.int32)
    geom[..., 2] = rng.integers(-1, 2, size=(b, n))
    return geom, rng.normal(size=(b, n, c)).astype(np.float32)


def test_voxel_pooling_matches_jax_and_the_loop():
    """Out-of-range x, y and z dropped; each cell the sum of its points."""
    geom, feats = _pooling_case()
    voxel_num = (16, 12, 1)
    got = tvp.voxel_pooling(torch.from_numpy(geom), torch.from_numpy(feats), voxel_num)
    want = np.asarray(jvp.voxel_pooling(jnp.asarray(geom), jnp.asarray(feats), voxel_num))
    assert got.shape == want.shape == (2, 12, 16, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    loop = np.zeros_like(want)
    for bi in range(2):
        for (x, y, z), f in zip(geom[bi], feats[bi]):
            if 0 <= x < 16 and 0 <= y < 12 and z == 0:
                loop[bi, y, x] += f
    np.testing.assert_allclose(got.numpy(), loop, rtol=1e-5, atol=1e-5)


def test_lift_splat_matrix_matches_jax_and_lift_splat():
    rng = np.random.default_rng(2)
    m, d, p, c, g = 2, 12, 24, 8, 30
    depth = rng.random((m, d, p)).astype(np.float32)
    ctx = rng.normal(size=(m, p, c)).astype(np.float32)
    idx = rng.integers(0, g + 1, size=(m, d, p)).astype(np.int32)      # g: the trash cell
    got = tvp.lift_splat_matrix(torch.from_numpy(depth), torch.from_numpy(ctx),
                                torch.from_numpy(idx), g)
    want = np.asarray(jvp.lift_splat_matrix(jnp.asarray(depth), jnp.asarray(ctx),
                                            jnp.asarray(idx), g))
    assert got.shape == want.shape == (m, g, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = tvp.lift_splat_plain(torch.from_numpy(depth), torch.from_numpy(ctx),
                                 torch.from_numpy(idx), g)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)


def test_voxel_pooling_gradient_matches_jax_vjp():
    """The output gradient gathered at each kept point's cell, zero for a
    dropped point; on the hand-made case of the JAX test and on a seeded
    one, against ``jax.vjp``."""
    hand = (np.array([[[0, 0, 0], [1, 1, 0], [1, 1, 0], [-1, 2, 0]]], np.int32),
            np.ones((1, 4, 2), np.float32), (4, 4, 1))
    geom, feats = _pooling_case(seed=3, n=200, c=4)
    for geom, feats, voxel_num in (hand, (geom, feats, (16, 12, 1))):
        gy = np.random.default_rng(1).normal(
            size=(geom.shape[0], voxel_num[1], voxel_num[0], feats.shape[-1])).astype(np.float32)
        _, vjp = jax.vjp(lambda f: jvp.voxel_pooling(jnp.asarray(geom), f, voxel_num),
                         jnp.asarray(feats))
        want = np.asarray(vjp(jnp.asarray(gy))[0])
        f = torch.from_numpy(feats).requires_grad_()
        tvp.voxel_pooling(torch.from_numpy(geom), f, voxel_num).backward(torch.from_numpy(gy))
        np.testing.assert_allclose(f.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(f.grad.numpy()[geom[..., 0] < 0], 0.0)
