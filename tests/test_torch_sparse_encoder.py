"""The port's sparse-import LiDAR encoder (``models/sparse_encoder.py``), K1's
sparse-input mode (``ops/voxelize.py::sparse_encoder_input``) and kernel A's
masked form (``ops/affine_act.py::affine_act_masked``), each through its
plain version on the CPU, against the JAX package: ``ImportSparseEncoder``
(eval forward, train forward and ``jax.vjp`` in float64), the true sparse
convolution of ``tests/test_models/test_sparse_encoder.py::
np_sparse_encoder``, and ``voxelize_pillars_dense(max_points_per_voxel=K,
return_count=True)``."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mm_training_tpu.models import torch_import as j_ti
from mm_training_tpu.models.sparse_encoder import ImportSparseEncoder as JEncoder
from mm_training_tpu.ops.voxelize import voxelize_pillars_dense as j_voxelize
from mm_training_tpu_torch.configs import LidarEncoderConf
from mm_training_tpu_torch.models.bn_fold import begin_step
from mm_training_tpu_torch.models.sparse_encoder import SparseEncoder, dilate_stride2
from mm_training_tpu_torch.models.torch_import import convert_sparse_encoder
from mm_training_tpu_torch.models.weights import sparse_encoder_state_dict
from mm_training_tpu_torch.ops import affine_act, voxelize
from tests.test_models.test_sparse_encoder import (CHANNELS, _flax_encoder, _make_state_dict,
                                                   _random_plane_sites, np_sparse_encoder)
from tests.torch_port_helpers import nchw, nhwc

HW = (16, 32)
PC = (-3.2, -1.6, -5.0, 3.2, 1.6, 3.0)
VS = (0.2, 0.2, 8.0)


def _state_dict(rng):
    """``_make_state_dict``'s weights rounded to float32, as the JAX merge
    into its float32 init rounds them, so both packages hold the same
    values also in float64."""
    return {k: np.asarray(v, np.float32) if np.asarray(v).dtype.kind == 'f' else v
            for k, v in _make_state_dict(rng).items()}


def _plane(sites, hw=HW, nf=5):
    grid = np.zeros((1,) + hw + (nf,), np.float64)
    occ = np.zeros((1,) + hw + (1,), np.float64)
    for (_, h, w), f in sites.items():
        grid[0, h, w] = f
        occ[0, h, w] = 1.0
    return grid, occ


def _port_encoder(sd, dtype=torch.float32):
    enc = SparseEncoder(LidarEncoderConf()).to(dtype)
    enc.load_state_dict(convert_sparse_encoder(
        {k: torch.as_tensor(np.asarray(v)).to(dtype) if np.asarray(v).dtype.kind == 'f'
         else torch.as_tensor(np.asarray(v)) for k, v in sd.items()}, CHANNELS))
    return enc.eval()


def _occ_mask(occ):
    return torch.from_numpy(occ[..., 0] > 0)[:, None].contiguous()


def _j_encode(sd, grid, occ, train=False, dtype=jnp.float32):
    model = _flax_encoder(grid.shape[1:3])
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(grid, dtype),
                           jnp.asarray(occ, dtype), False, method=JEncoder.encode)
    params, stats = j_ti.convert_sparse_encoder(sd, CHANNELS)
    merged = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                    j_ti.merge_subtree(variables, params, stats))
    return model, merged


def test_eval_forward_matches_jax_and_the_true_sparse_conv():
    """Eval forward on 48 random active pillars of a 16 x 32 grid: within
    1e-4 (of the largest output) of JAX's ``encode`` and of the gather-based
    sparse convolution; the odd (plane-1) channels exactly zero."""
    rng = np.random.default_rng(0)
    sd = _state_dict(rng)
    sites = _random_plane_sites(rng, HW, n=48)
    ref = np_sparse_encoder(sd, sites, (41,) + HW)            # [256, 2, 4]
    grid, occ = _plane(sites)
    model, merged = _j_encode(sd, grid, occ)
    apply = jax.jit(lambda v, g, o: model.apply(v, g, o, False, method=JEncoder.encode))
    want = np.asarray(apply(merged, jnp.asarray(grid, jnp.float32),
                            jnp.asarray(occ, jnp.float32)))[0].transpose(2, 0, 1)
    enc = _port_encoder(sd)
    with torch.no_grad():
        got = enc(nchw(grid.astype(np.float32)), _occ_mask(occ))
    assert got.shape == (1, 256, 2, 4) and got.dtype == torch.float32
    got = got[0].numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() / scale < 1e-4
    assert np.abs(got - want).max() / scale < 1e-4
    assert np.abs(got[1::2]).max() == 0.0 and np.abs(got[0::2]).max() > 0.1


def test_empty_input_is_all_zero():
    """No active pillar: an all-zero BEV despite the BNs' nonzero affine
    (the mask multiplies each tail), as in the JAX module."""
    sd = _state_dict(np.random.default_rng(1))
    enc = _port_encoder(sd)
    with torch.no_grad():
        out = enc(torch.zeros(1, 5, 16, 16), torch.zeros(1, 1, 16, 16, dtype=torch.bool))
    assert out.shape == (1, 256, 2, 2) and out.abs().max().item() == 0.0


@functools.lru_cache(maxsize=None)
def _j_train_fn(hw):
    """A jitted float64 train-mode forward and ``jax.vjp`` of JAX's
    ``encode`` on an ``hw`` grid: (params, stats, grid, occ, cotangent) ->
    (output, updated stats, grads of params and grid)."""
    model = _flax_encoder(hw)

    def run(params, stats, grid, occ, cot):
        def f(p, g):
            return model.apply({'params': p, 'batch_stats': stats}, g, occ, True,
                               method=JEncoder.encode, mutable=['batch_stats'])
        out, vjp, upd = jax.vjp(f, params, grid, has_aux=True)
        return (out, upd['batch_stats']) + vjp(cot)
    return jax.jit(run)


def _train_case(sd, grid, occ, cot):
    """(JAX output, updated stats, grads of params and grid) and the port's,
    one train-mode forward and backward in float64."""
    x64 = jax.config.jax_enable_x64
    jax.config.update('jax_enable_x64', True)
    try:
        _, merged = _j_encode(sd, grid, occ, dtype=jnp.float64)
        want = _j_train_fn(grid.shape[1:3])(
            merged['params'], merged['batch_stats'],
            *(jnp.asarray(a, jnp.float64) for a in (grid, occ, cot)))
        want = jax.tree_util.tree_map(np.asarray, want)
    finally:
        jax.config.update('jax_enable_x64', x64)
    enc = _port_encoder(sd, torch.float64).train()
    begin_step(enc)
    x = nchw(grid).clone().requires_grad_()
    out = enc(x, _occ_mask(occ))
    out.backward(torch.from_numpy(np.ascontiguousarray(cot.transpose(0, 3, 1, 2))))
    return want, (enc, out.detach(), x.grad)


def test_train_forward_statistics_and_gradients_match_jax_vjp_in_float64():
    """Train mode (masked batch statistics) in float64 on a 16 x 32 grid:
    the output within 1e-9 of JAX's, odd channels zero; the running
    statistics after the step (flax's masked fast-variance statistics,
    momentum 0.99) within 1e-5; every parameter's gradient and the grid's
    within 1e-4 of its tensor's largest (the existing train-parity
    tolerances)."""
    rng = np.random.default_rng(2)
    sd = _state_dict(rng)
    grid, occ = _plane(_random_plane_sites(rng, HW, n=64))
    cot = rng.normal(0.0, 1.0, (1, 2, 4, 256))
    (j_out, j_stats, j_gp, j_gx), (enc, out, gx) = _train_case(sd, grid, occ, cot)
    got = nhwc(out)
    assert np.abs(got - j_out).max() <= 1e-9 * np.abs(j_out).max()
    assert np.abs(got[..., 1::2]).max() == 0.0
    carried = sparse_encoder_state_dict(j_gp, j_stats, LidarEncoderConf())
    n_grads = n_stats = 0
    for name, p in enc.named_parameters():
        want = carried[name].numpy()
        assert np.abs(p.grad.numpy() - want).max() <= 1e-4 * np.abs(want).max(), name
        n_grads += 1
    for name, b in enc.named_buffers():
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(b.numpy(), carried[name].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            n_stats += 1
    assert n_grads == 3 * 21 and n_stats == 2 * 21
    assert np.abs(nhwc(gx) - j_gx).max() <= 1e-4 * np.abs(j_gx).max()


def test_masked_statistics_of_an_empty_mask_are_nan_as_in_jax():
    """flax's ``mean(where=all False)`` is NaN, so a train-mode forward with
    no active pillar gives NaN statistics and NaN features in JAX (the
    interleaved zero channels stay zero); the port does the same (not a
    guard that hides it)."""
    sd = _state_dict(np.random.default_rng(3))
    grid, occ = np.zeros((1,) + HW + (5,)), np.zeros((1,) + HW + (1,))
    (j_out, j_stats, _, _), (enc, out, _) = _train_case(sd, grid, occ,
                                                         np.ones((1, 2, 4, 256)))
    got = nhwc(out)
    # the features NaN, the interleaved zero plane still zero
    assert np.isnan(j_out[..., 0::2]).all() and np.isnan(got[..., 0::2]).all()
    assert (j_out[..., 1::2] == 0).all() and (got[..., 1::2] == 0).all()
    assert np.isnan(j_stats['conv_input']['bn']['mean']).all()
    assert torch.isnan(enc.conv_input[1].running_mean).all()


def test_dilate_stride2_is_the_strided_sparse_convs_active_set():
    """The 3x3/2/1 max-pool of the mask (JAX ``_dilate_stride2``)."""
    m = torch.zeros(1, 1, 8, 8, dtype=torch.bool)
    m[0, 0, 3, 4] = True
    want = np.zeros((4, 4), bool)
    want[1:3, 2] = True     # outputs 1, 2 in y and 2 in x read input row 3, column 4
    np.testing.assert_array_equal(dilate_stride2(m)[0, 0].numpy(), want)


def _clustered_points(rng, b=2, p=600):
    """Points in range with three dense clusters (pillars of 20-150 points),
    some outside the range and some masked out; 8 features."""
    pts = np.zeros((b, p, 8), np.float32)
    pts[..., 0] = rng.uniform(PC[0] - 1, PC[3] + 1, (b, p))
    pts[..., 1] = rng.uniform(PC[1] - 0.5, PC[4] + 0.5, (b, p))
    pts[..., 2] = rng.uniform(PC[2], PC[5], (b, p))
    pts[..., 3:] = rng.normal(0, 1, (b, p, 5))
    for c, (x, y, n) in enumerate(((0.05, 0.05, 150), (1.01, -0.33, 60), (-2.9, 1.5, 20))):
        sel = rng.choice(p, n, replace=False)
        pts[np.arange(b)[:, None], sel[None], 0] = x + rng.uniform(0, 0.15, (b, n))
        pts[np.arange(b)[:, None], sel[None], 1] = y + rng.uniform(0, 0.15, (b, n))
    mask = rng.uniform(size=(b, p)) < 0.9
    return pts, mask


def _first_k_numpy(pts, mask, k, hw=HW):
    """The first ``k`` masked-in points in range of each pillar, in input
    order (mmdet3d's hard voxelizer), by a plain loop."""
    kept = np.zeros(mask.shape, bool)
    for bi in range(pts.shape[0]):
        seen = {}
        for i in range(pts.shape[1]):
            xi = int(np.floor((pts[bi, i, 0] - np.float32(PC[0])) / np.float32(VS[0])))
            yi = int(np.floor((pts[bi, i, 1] - np.float32(PC[1])) / np.float32(VS[1])))
            if not (mask[bi, i] and 0 <= xi < hw[1] and 0 <= yi < hw[0]):
                continue
            n = seen.get((yi, xi), 0)
            kept[bi, i] = n < k
            seen[(yi, xi)] = n + 1
    return kept


@pytest.mark.parametrize('cap', [15, 3, 1])
def test_k1_sparse_mode_matches_jax_voxelize_with_the_cap(cap):
    """The sparse mode's plain version on points with overfull pillars
    against JAX's ``voxelize_pillars_dense(max_points_per_voxel=cap,
    return_count=True)``: the kept set equal to the first ``cap`` points of
    each pillar in input order (exact), each pillar's kept count equal to
    JAX's count, the means within 1e-6, the padding channels zero, the
    occupancy JAX's count > 0."""
    rng = np.random.default_rng(4)
    pts, mask = _clustered_points(rng)
    vox = jax.vmap(lambda p, m: j_voxelize(p, m, PC, VS, HW, num_features=5,
                                           max_points_per_voxel=cap, return_count=True))
    j_mean, j_count = (np.asarray(a) for a in vox(jnp.asarray(pts), jnp.asarray(mask)))
    grid, occ, kept = voxelize.sparse_encoder_input(
        torch.from_numpy(pts), torch.from_numpy(mask), PC, VS, HW, 5, torch.float32, 8,
        max_points_per_voxel=cap, return_kept=True)
    assert grid.shape == (2, 16, 32, 8) and occ.shape == (2, 1, 16, 32) and occ.dtype == torch.bool
    assert j_count.max() == cap    # overfull pillars were capped
    np.testing.assert_array_equal(kept.numpy(), _first_k_numpy(pts, mask, cap))
    seg = voxelize.pillar_segments(torch.from_numpy(pts), torch.from_numpy(mask), PC, VS,
                                   HW).numpy()
    for bi in range(2):
        counts = np.bincount(seg[bi][kept[bi].numpy()], minlength=16 * 32)
        np.testing.assert_array_equal(counts.reshape(16, 32), j_count[bi, ..., 0])
    np.testing.assert_allclose(grid[..., :5].numpy(), j_mean, rtol=1e-6, atol=1e-6)
    assert grid[..., 5:].abs().max().item() == 0.0
    np.testing.assert_array_equal(occ[:, 0].numpy(), j_count[..., 0] > 0)


def test_k1_sparse_mode_bf16_rounds_the_float32_mean_once():
    """In bf16 the grid is the float32 mean rounded once."""
    pts, mask = _clustered_points(np.random.default_rng(5))
    args = (torch.from_numpy(pts), torch.from_numpy(mask), PC, VS, HW, 5)
    g32, o32 = voxelize.sparse_encoder_input(*args, torch.float32, 8, max_points_per_voxel=15)
    g16, o16 = voxelize.sparse_encoder_input(*args, torch.bfloat16, 8, max_points_per_voxel=15)
    assert g16.dtype == torch.bfloat16 and torch.equal(g16, g32.to(torch.bfloat16))
    assert torch.equal(o16, o32)


def test_masked_affine_act_and_backward_match_the_jax_tail():
    """Kernel A's masked form and its backward (plain versions, float64)
    against ``jax.vjp`` of the JAX module's tail ``relu(bn(x) * mask +
    r)`` with the BN as its affine: the output, dx, d residual and the
    per-channel d scale, d shift within 1e-12."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 6, 16))
    m = (rng.uniform(size=(2, 5, 6, 1)) < 0.6).astype(np.float64)
    r = np.maximum(rng.normal(size=x.shape), 0) * m
    s, t = rng.normal(1, 0.3, 16), rng.normal(0, 0.3, 16)
    g = rng.normal(size=x.shape)
    x64 = jax.config.jax_enable_x64
    jax.config.update('jax_enable_x64', True)
    try:
        def tail(x_, s_, t_, r_):
            return jax.nn.relu((x_ * s_ + t_) * m + r_)
        out, vjp = jax.vjp(tail, *(jnp.asarray(a) for a in (x, s, t, r)))
        want = [np.asarray(a) for a in (out,) + vjp(jnp.asarray(g))]
    finally:
        jax.config.update('jax_enable_x64', x64)
    mask = torch.from_numpy(m[..., 0] > 0)[:, None].contiguous()
    tx, tr, tg = nchw(x), nchw(r), nchw(g)
    ts, tt = torch.from_numpy(s), torch.from_numpy(t)
    got = affine_act.affine_act_masked(tx, ts, tt, mask, tr)
    dx, dr, ds, dt = affine_act.affine_act_masked_backward(tg, tx, ts, tt, mask, tr)
    for a, b in ((nhwc(got), want[0]), (nhwc(dx), want[1]), (ds.numpy(), want[2]),
                 (dt.numpy(), want[3]), (nhwc(dr), want[4])):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    # through AffineAct, as the masked BNs reach it with gradients on
    xg = tx.clone().requires_grad_()
    affine_act.AffineAct.apply(xg, ts, tt, tr, True, mask).backward(tg)
    np.testing.assert_allclose(nhwc(xg.grad), want[1], rtol=1e-12, atol=1e-12)
