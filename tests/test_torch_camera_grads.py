"""Gradients of the camera kernels' plain versions (K4 lift-splat, K5
deformable conv, K7 BEV warp) against ``jax.vjp`` of the JAX package's
functions, the depth loss against the JAX step's ``depth_loss_fn``, and the
pieces of the camera train step that carry the JAX step's random draws
(ASPP's dropout mask, the flips) and its BatchNorm statistics order; fp32 on
the CPU. The kernels' backwards are held against these plain versions on
the card (tests/test_torch_cuda.py).

Inputs come from numpy with a seed and are built so that a shortcut would
show: K4 gets trash-cell rows and rows masked out by zvalid, K5 offsets on
whole pixels (floor has no gradient: one-sided differences there), between
pixels and far outside the image, K7 a rotated, flipped and scaled BEV
augmentation.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_training_tpu.models.depth_net import DeformConv2d as JDeformConv2d
from mm_training_tpu.ops import warp as jwarp
from mm_training_tpu.ops.voxel_pooling import lift_splat_factorized as j_lift_splat
from mm_training_tpu.training.train_step import depth_loss_fn as j_depth_loss
from mm_training_tpu_torch.data import random_bda_matrices
from mm_training_tpu_torch.ops import deform_conv, voxel_pooling, warp
from mm_training_tpu_torch.training import depth_loss_fn


def _close_to_terms(got, want, magnitude, tol=1e-5):
    """Each entry within ``tol`` of its sum of |terms| (fp32 sums taken in
    another order), plus a float32 ulp of the entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = tol * np.asarray(magnitude, np.float64) + 1.2e-7 * np.abs(want)
    worst = float((np.abs(got - want) - bound).max())
    assert worst <= 0.0, worst


def _rel_close(got, want, tol):
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * max(1e-30, float(np.abs(want).max())), err


# ------------------------------------------------------------------ K4

def test_lift_splat_gradients_match_jax_vjp():
    """d depth and d ctx of the factorized splat: rows masked out by zvalid
    get no depth gradient, trash-cell rows (``idx == n_cells``) gather a zero
    gradient; each entry within 1e-5 of its sum of |terms|."""
    rng = np.random.default_rng(40)
    m, d, fh, fw, c, n_cells = 3, 20, 6, 10, 16, 40
    depth = rng.uniform(0, 1, (m, d, fh, fw)).astype(np.float32)
    ctx = rng.normal(size=(m, fh, fw, c)).astype(np.float32)
    idx = rng.integers(0, n_cells + 1, (m, d, fw)).astype(np.int32)
    idx[:, :3] = n_cells                                  # whole bins in the trash cell
    zvalid = rng.uniform(size=(m, d, fh, fw)) < 0.7
    g = rng.normal(size=(m, n_cells, c)).astype(np.float32)
    assert (idx == n_cells).mean() > 0.1 and (~zvalid).any()

    _, vjp = jax.vjp(lambda a, b: j_lift_splat(a, b, jnp.asarray(idx), jnp.asarray(zvalid),
                                               n_cells), jnp.asarray(depth), jnp.asarray(ctx))
    want_depth, want_ctx = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    t = [torch.from_numpy(a) for a in (g, depth, ctx, idx, zvalid)]
    got_depth, got_ctx = voxel_pooling.lift_splat_factorized_backward(*t, n_cells)
    assert got_depth.dtype == got_ctx.dtype == torch.float32
    # the sums of |terms|, from the same (linear) backward on magnitudes
    mag_depth, _ = voxel_pooling.lift_splat_factorized_backward_plain(
        t[0].abs().double(), t[1].double(), t[2].abs().double(), t[3], t[4], n_cells)
    _, mag_ctx = voxel_pooling.lift_splat_factorized_backward_plain(
        t[0].abs().double(), t[1].double(), t[2].double(), t[3], t[4], n_cells)
    _close_to_terms(got_depth.numpy(), want_depth, mag_depth.numpy())
    _close_to_terms(got_ctx.numpy(), want_ctx, mag_ctx.numpy())
    assert not got_depth.numpy()[~zvalid].any()
    trash = np.broadcast_to((idx == n_cells)[:, :, None, :], depth.shape)
    assert not got_depth.numpy()[trash].any()
    # autograd through the wrapper on CPU tensors is the same plain version
    dep = t[1].clone().requires_grad_()
    cx = t[2].clone().requires_grad_()
    voxel_pooling.lift_splat_factorized(dep, cx, t[3], t[4], n_cells).backward(t[0])
    assert torch.equal(dep.grad, got_depth) and torch.equal(cx.grad, got_ctx)


# ------------------------------------------------------------------ K5

def _dcn_case(kind, seed):
    """x [2, 6, 10, 16], offsets [2, 6, 10, 18], the JAX kernel [9, 4, 4, 4]
    and bias: ``kind`` 'integer' (every sampling point on a whole pixel),
    'fractional' (between pixels, up to 2 px) or 'outside' (up to 9 px: most
    taps at the border have corners outside the image)."""
    rng = np.random.default_rng(seed)
    b, h, w, c = 2, 6, 10, 16
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    reach = {'integer': 2.0, 'fractional': 2.0, 'outside': 9.0}[kind]
    off = rng.uniform(-reach, reach, (b, h, w, 18))
    if kind == 'integer':
        off = np.round(off)
    else:
        off = np.where(np.abs(off - np.round(off)) < 0.05, off + 0.1, off)
    kernel = rng.normal(0, 0.2, (9, 4, 4, 4)).astype(np.float32)
    bias = rng.normal(0, 0.2, (c,)).astype(np.float32)
    return x, off.astype(np.float32), kernel, bias


def _j_dcn(x, off, kernel, bias):
    """The JAX DeformConv2d with its offset conv's output replaced by off."""
    jm = JDeformConv2d(features=x.shape[-1], groups=4)
    params = jm.init(jax.random.PRNGKey(0), x)['params']

    def offsets_in(next_fun, args, kwargs, context):
        if context.module.name == 'conv_offset':
            return off
        return next_fun(*args, **kwargs)
    with fnn.intercept_methods(offsets_in):
        return jm.apply({'params': dict(params, kernel=kernel, bias=bias)}, x)


@pytest.mark.parametrize('kind', ['integer', 'fractional', 'outside'])
def test_deform_conv_gradients_match_jax_vjp(kind):
    """d x, d offsets, d kernel and d bias of the deformable conv after its
    offset conv against ``jax.vjp`` of the JAX module (its offset conv's
    output fed in): at whole pixels floor's zero gradient leaves the
    one-sided difference of the corners (the JAX package's), corners outside
    the image weigh 0 and pass nothing. Each within 1e-5 of the largest
    entry of its tensor (fp32 sums over taps and channels in another
    order)."""
    x, off, kernel, bias = _dcn_case(kind, {'integer': 41, 'fractional': 42, 'outside': 43}[kind])
    b, h, w, c = x.shape
    g = np.random.default_rng(44).normal(size=(b, h, w, c)).astype(np.float32)
    _, vjp = jax.vjp(_j_dcn, *(jnp.asarray(a) for a in (x, off, kernel, bias)))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    packed = torch.from_numpy(np.ascontiguousarray(kernel.transpose(1, 0, 2, 3).reshape(4, 36, 4)))
    got = deform_conv.deform_conv3x3_backward(
        torch.from_numpy(g), torch.from_numpy(x), torch.from_numpy(off), packed,
        torch.from_numpy(bias), 4)
    want[2] = want[2].transpose(1, 0, 2, 3).reshape(4, 36, 4)
    for name, gt, wt in zip(('x', 'offsets', 'kernel', 'bias'), got, want):
        assert gt.dtype == torch.float32, name
        _rel_close(gt.numpy(), wt, 1e-5)
    py = np.arange(h)[None, :, None, None] + (np.arange(9) // 3 - 1) + off[..., 0::2]
    if kind == 'integer':     # the offset gradient is the one-sided difference, not zero
        assert np.abs(want[1]).max() > 0.1
    if kind == 'outside':
        assert ((py < 0) | (py > h - 1)).mean() > 0.3


def test_deform_sample_backward_is_the_columns_transpose():
    """K5's transposed sampling (:func:`deform_sample_backward_plain`, the
    part of the backward that kernel K5' runs on its own d cols, and the
    reference it is held to on the card) is the adjoint of the columns:
    <d cols, cols(x)> = <d x, x> (the columns are linear in x), and d offsets is the
    derivative of <d cols, cols> along the offsets, checked against a
    central difference at points off the pixel grid; the columns' gradient
    comes laid out as the grouped product leaves it, [g, B*H*W, 9*C/g]."""
    x, off, _, _ = _dcn_case('fractional', 45)
    b, h, w, c = x.shape
    rng = np.random.default_rng(46)
    dcols = torch.from_numpy(rng.normal(size=(4, b * h * w, 9 * 4)).astype(np.float32)).double()
    xt, ot = torch.from_numpy(x).double(), torch.from_numpy(off)
    dx, doff = deform_conv.deform_sample_backward_plain(dcols, xt, ot, 4)
    assert dx.dtype == torch.float64 and doff.dtype == torch.float32

    def inner(o):
        cols = deform_conv.deform_sample_plain(xt, o)               # [B, HW, 9, C]
        cg = cols.reshape(b * h * w, 9, 4, 4).permute(2, 0, 1, 3).reshape(4, -1, 36)
        return float((cg * dcols).sum())
    assert abs(inner(ot) - float((dx * xt).sum())) <= 1e-9 * abs(inner(ot))
    eps = 1e-3
    for i in (0, 5, 17):
        bump = torch.zeros_like(ot)
        bump[1, 2, 3, i] = eps
        numeric = (inner(ot + bump) - inner(ot - bump)) / (2 * eps)
        assert abs(numeric - float(doff[1, 2, 3, i])) <= 1e-3 * max(1.0, abs(numeric)), i


# ------------------------------------------------------------------ K7

@pytest.mark.parametrize('shape', [(2, 16, 32, 8), (2, 9, 13, 3)])
def test_bev_warp_gradients_match_jax_vjp(shape):
    """d map of ``bda_bev_warp`` under a rotated, flipped and scaled BEV
    augmentation (``random_bda_matrices``) and of ``warp_affine_nhwc`` on
    its pixel matrix, against ``jax.vjp`` of the JAX warps: the transposed
    bilinear sample (each source pixel takes the weights of the dst pixels
    that sample its 2 x 2 neighbourhood, zero padding). Within 1e-5 of the
    largest entry, as the forward is held (the closed-form inverse and the
    JAX package's LU inverse differ by float32 ulps, which move the source
    points, and so each corner's weight, by up to ~1e-6: not an order of
    sums, so not bounded by each entry's sum of |terms|); the matrix gets no
    gradient."""
    rng = np.random.default_rng(47)
    img = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    bda = random_bda_matrices(shape[0], seed=48)
    assert not np.allclose(bda[:, :3, :3], np.eye(3))
    mat = warp.bda_pixel_matrix(torch.from_numpy(bda), shape[1:3])
    for j_fn, t_mat, bda_n in ((jwarp.bda_bev_warp, torch.from_numpy(bda), 4),
                               (jwarp.warp_affine_nhwc, mat, 0)):
        _, vjp = jax.vjp(lambda a: j_fn(a, jnp.asarray(t_mat.numpy())), jnp.asarray(img))
        (want,) = vjp(jnp.asarray(g))
        got = warp.warp_backward(torch.from_numpy(g), torch.from_numpy(img), t_mat, bda_n)
        _rel_close(got.numpy(), want, 1e-5)
        src = torch.from_numpy(img).requires_grad_()
        fn = warp.bda_bev_warp if bda_n else warp.warp_affine_nhwc
        fn(src, t_mat).backward(torch.from_numpy(g))
        assert torch.equal(src.grad, got)


# ------------------------------------------------------------------ the depth loss

@pytest.mark.parametrize('masked', [False, True])
def test_depth_loss_matches_jax(masked):
    """``depth_loss_fn``: 3 x the foreground-masked BCE, clip 1e-7, on the
    port's [B*N, D, fH, fW] depth against the JAX [B*N, fH, fW, D] one;
    labels one-hot with some all-zero pixels (foreground off there), the
    sample mask dropping the second sample's cameras. Loss to 1e-6
    relative, its gradient to 1e-5 of the largest entry."""
    rng = np.random.default_rng(49)
    bn, fh, fw, d = 4, 3, 5, 12
    labels = np.eye(d, dtype=np.float32)[rng.integers(0, d, (bn, fh, fw))]
    labels[rng.uniform(size=(bn, fh, fw)) < 0.2] = 0.0
    logits = rng.normal(0, 3, (bn, fh, fw, d)).astype(np.float32)
    logits[0, 0, 0, 0] = 40.0      # a probability past the clip
    pred = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    mask = np.array([True, False]) if masked else None

    def j_loss(p):
        return j_depth_loss(jnp.asarray(labels), p,
                            None if mask is None else jnp.asarray(mask))
    want, want_grad = jax.value_and_grad(j_loss)(jnp.asarray(pred))
    p = torch.from_numpy(pred).permute(0, 3, 1, 2).requires_grad_()
    got = depth_loss_fn(torch.from_numpy(labels), p,
                        None if mask is None else torch.from_numpy(mask))
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    _rel_close(p.grad.permute(0, 2, 3, 1).numpy(), want_grad, 1e-5)
    if masked:
        assert not p.grad[2:].any()
