"""The plain versions of the camera kernels K4-K7 and the lift geometry
against the JAX package's functions, fp32, on the CPU (the kernels
themselves are held against these plain versions on the card,
tests/test_torch_cuda.py).

Inputs come from numpy with a seed and are built so that a shortcut would
show: K4 gets trash-bin rows and a row-dependent z mask, K5 offsets of up to
3 px (some taps off the map, some on exact integers), K6 points behind the
cameras, inside the 1-px border and two in one 16 x 16 cell, K7 a rotated,
flipped and scaled BEV augmentation and projective matrices (its
closed-form inverse against float64).
"""
import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mm_training_tpu.configs as jcfg
from mm_training_tpu.core import geometry as jgeo
from mm_training_tpu.data.fake_batch import make_fake_batch
from mm_training_tpu.models.depth_net import DeformConv2d as JDeformConv2d
from mm_training_tpu.ops import warp as jwarp
from mm_training_tpu.ops.voxel_pooling import lift_splat_factorized as j_lift_splat
from mm_training_tpu_torch.core import geometry as tgeo
from mm_training_tpu_torch.models.depth_net import DeformConv2d
from mm_training_tpu_torch.ops import deform_conv, depth_labels, voxel_pooling, warp
from mm_training_tpu_torch.data import random_bda_matrices
from mm_training_tpu_torch.exps.kernel_inputs import depth_label_case

# the module, not the function of the same name that the package exports
j_depth_labels = importlib.import_module('mm_training_tpu.ops.depth_labels')


def _rel_close(got, want, tol=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * max(1e-30, float(np.abs(want).max())), err


# ------------------------------------------------------------------ geometry

def _rig(num_cameras=2, hw=(64, 128), b=2):
    cfg = jcfg.tiny_test_config(use_cam=True, num_cameras=num_cameras, H=hw[0], W=hw[1])
    batch = make_fake_batch(cfg, batch_size=b, seed=20)
    return batch['sensor2ego'][:, 0], batch['intrin'][:, 0], batch['extrinsics'][:, 0]


def test_frustum_and_geometry_match_jax():
    d_bound, final_dim = (2.0, 27.2, 0.5), (64, 128)
    fr = tgeo.create_frustum(d_bound, final_dim, 16)
    np.testing.assert_array_equal(fr, jgeo.create_frustum(d_bound, final_dim, 16))
    s2e, intr, _ = _rig()
    want = np.asarray(jgeo.get_geometry(jnp.asarray(fr), jnp.asarray(s2e), jnp.asarray(intr)))
    got = tgeo.get_geometry(torch.from_numpy(fr), torch.from_numpy(s2e),
                            torch.from_numpy(intr)).numpy()
    assert got.shape == (2, 2, 51, 4, 8, 3)      # arange(2.0, 27.2, 0.5): 51 bins
    _rel_close(got, want)
    assert tgeo.rig_is_row_independent(s2e, intr) == jgeo.rig_is_row_independent(s2e, intr)


def _jit_cells(fr, s2e, intr, vc, vs, vn):
    """The JAX chain compiled, as the predict step runs it (XLA turns the
    division by the constant voxel size into a product with its
    reciprocal)."""
    def cells(fr, s2e, intr):
        g = jgeo.get_geometry(fr, s2e, intr)
        return jgeo.flat_bev_index(jgeo.quantize_geometry(g, vc, vs), vn)
    return np.asarray(jax.jit(cells)(jnp.asarray(fr), jnp.asarray(s2e), jnp.asarray(intr)))


@pytest.mark.parametrize('production', [False, True])
def test_quantize_and_flat_index_match_jax(production):
    """Indices of every frustum point, at the tiny geometry and at the
    production one (4 cameras of 704 x 1280, 409 bins, 1.6 m cells): equal
    in at least 99.9% of points, and where the two frameworks' last-ulp
    rounding moves a point across a cell edge, into a neighbouring cell
    only."""
    if production:
        d_bound, final_dim = (2.0, 206.4, 0.5), (704, 1280)
        s2e, intr, _ = _rig(4, final_dim, b=1)
        vc, vs, vn = (-204.8 + 0.8, -25.6 + 0.8, -1.0), (1.6, 1.6, 8.0), (256, 32, 1)
    else:
        d_bound, final_dim = (2.0, 27.2, 0.5), (64, 128)
        s2e, intr, _ = _rig()
        vc, vs, vn = (-25.6 + 0.8, -12.8 + 0.8, -1.0), (1.6, 1.6, 8.0), (32, 16, 1)
    fr = tgeo.create_frustum(d_bound, final_dim, 16)
    want = _jit_cells(fr, s2e, intr, vc, vs, vn)
    tg = tgeo.get_geometry(torch.from_numpy(fr), torch.from_numpy(s2e), torch.from_numpy(intr))
    got = tgeo.flat_bev_index(tgeo.quantize_geometry(tg, vc, vs), vn).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    diff = got != want
    assert diff.mean() <= 1e-3, diff.mean()
    g, w = got[diff], want[diff]
    nx, n_cells = vn[0], vn[0] * vn[1]
    assert 0 < (want < n_cells).mean() < 1           # in-grid and trash points
    inside = (g < n_cells) & (w < n_cells)
    assert (np.abs(g[inside] // nx - w[inside] // nx) <= 1).all()
    assert (np.abs(g[inside] % nx - w[inside] % nx) <= 1).all()


def test_quantize_truncates_toward_zero():
    """int() truncation: up to one voxel below the grid lands in voxel 0
    (floor would give -1 and the trash bin)."""
    xyz = np.array([[-0.79, 0.0, 0.0], [-0.81, 0.0, 0.0], [0.81, 0.79, 7.9],
                    [-1.7, -0.2, -8.5]], np.float32)
    vc, vs = (0.4, 0.4, 4.0), (0.8, 0.8, 8.0)
    got = tgeo.quantize_geometry(torch.from_numpy(xyz), vc, vs).numpy()
    want = np.asarray(jax.jit(lambda g: jgeo.quantize_geometry(g, vc, vs))(jnp.asarray(xyz)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[0, 0, 0], [-1, 0, 0], [1, 0, 0], [-2, 0, -1]])
    vn = (4, 4, 1)
    flat = tgeo.flat_bev_index(torch.from_numpy(got), vn).numpy()
    np.testing.assert_array_equal(flat, np.asarray(jgeo.flat_bev_index(jnp.asarray(want), vn)))
    np.testing.assert_array_equal(flat, [0, 16, 1, 16])


# ------------------------------------------------------------------ K4

def _splat_inputs(seed, m=3, d=20, fh=6, fw=10, c=16, n_cells=40):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0, 1, (m, d, fh, fw)).astype(np.float32)
    ctx = rng.normal(size=(m, fh, fw, c)).astype(np.float32)
    idx = rng.integers(0, n_cells + 1, (m, d, fw)).astype(np.int32)   # n_cells = trash
    zvalid = rng.uniform(size=(m, d, fh, fw)) < 0.7                  # row-dependent
    return depth, ctx, idx, zvalid, n_cells


def test_lift_splat_factorized_plain_matches_jax():
    depth, ctx, idx, zvalid, n_cells = _splat_inputs(21)
    assert (idx == n_cells).any()
    want = j_lift_splat(*(jnp.asarray(a) for a in (depth, ctx, idx, zvalid)), n_cells)
    got = voxel_pooling.lift_splat_factorized(
        *(torch.from_numpy(a) for a in (depth, ctx, idx, zvalid)), n_cells)
    assert got.dtype == torch.float32 and got.shape == (3, n_cells, 16)
    _rel_close(got.numpy(), want)


def test_lift_splat_factorized_keeps_the_compute_dtype():
    depth, ctx, idx, zvalid, n_cells = _splat_inputs(22)
    got = voxel_pooling.lift_splat_factorized(
        torch.from_numpy(depth).bfloat16(), torch.from_numpy(ctx).bfloat16(),
        torch.from_numpy(idx), torch.from_numpy(zvalid), n_cells)
    assert got.dtype == torch.bfloat16
    want = voxel_pooling.lift_splat_factorized_plain(
        *(torch.from_numpy(a) for a in (depth, ctx, idx, zvalid)), n_cells)
    assert (got.float() - want).abs().max() <= 2 ** -6 * want.abs().max()


@pytest.mark.parametrize('layout', ['channels_last', 'slice', 'nchw', 'contiguous'])
def test_splat_inputs_layouts(layout):
    """K4's shared test inputs (``exps/kernel_inputs.py``) at the tiny camera
    config, on the CPU: the same values in every layout, laid out as the
    layout says (ctx a permuted channels-last slice of the DepthNet output,
    pixel stride D + C; depth with d innermost, a slice of that output, or
    NCHW), depth a softmax over the bins, the rig's indices in [0, n_cells],
    and the plain splat the same as on contiguous copies."""
    from mm_training_tpu_torch.configs import tiny_test_config
    from mm_training_tpu_torch.exps.kernel_inputs import splat_inputs
    cfg = tiny_test_config(use_cam=True)
    got = splat_inputs(cfg, torch.Generator().manual_seed(3), layout, torch.float32)
    want = splat_inputs(cfg, torch.Generator().manual_seed(3), 'contiguous', torch.float32)
    depth, ctx, idx, zvalid, n_cells = got
    m, d, fh, fw = depth.shape
    c = ctx.shape[-1]
    assert n_cells == want[4] and torch.equal(idx, want[2]) and torch.equal(zvalid, want[3])
    assert idx.dtype == torch.int32 and 0 <= idx.min() and idx.max() <= n_cells
    assert (idx < n_cells).any() and zvalid.any()
    torch.testing.assert_close(depth, want[0], rtol=1e-6, atol=0)
    assert torch.equal(ctx, want[1])
    torch.testing.assert_close(depth.sum(1), torch.ones(m, fh, fw))
    strides = {'channels_last': (d * fh * fw, 1, fw * d, d),
               'slice': ((d + c) * fh * fw, 1, fw * (d + c), d + c),
               'nchw': (d * fh * fw, fh * fw, fw, 1),
               'contiguous': (d * fh * fw, fh * fw, fw, 1)}[layout]
    assert depth.stride() == strides
    if layout == 'contiguous':
        assert ctx.is_contiguous()
    else:
        assert ctx.stride() == ((d + c) * fh * fw, fw * (d + c), d + c, 1)
    torch.testing.assert_close(voxel_pooling.lift_splat_factorized(*got),
                               voxel_pooling.lift_splat_factorized(*want), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ K5

def _offsets(seed, b, h, w):
    """(dy, dx) of each tap in [-3, 3] px; a quarter on exact integers."""
    rng = np.random.default_rng(seed)
    off = rng.uniform(-3, 3, (b, h, w, 18))
    snap = rng.uniform(size=off.shape) < 0.25
    return np.where(snap, np.round(off), off).astype(np.float32)


def test_deform_conv_plain_matches_jax():
    """The sampling (K5's plain version) and the grouped product against
    the JAX DeformConv2d fed the same offsets (its offset conv's output
    replaced), float32."""
    b, h, w, c = 2, 7, 9, 16
    rng = np.random.default_rng(23)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    off = _offsets(24, b, h, w)
    jm = JDeformConv2d(features=c, groups=4)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    params = dict(params, kernel=jnp.asarray(rng.normal(0, 0.2, (9, 4, 4, 4)), jnp.float32),
                  bias=jnp.asarray(rng.normal(0, 0.2, (c,)), jnp.float32))

    def offsets_in(next_fun, args, kwargs, context):
        if context.module.name == 'conv_offset':
            return jnp.asarray(off)
        return next_fun(*args, **kwargs)
    with fnn.intercept_methods(offsets_in):
        want = jm.apply({'params': params}, jnp.asarray(x))

    tm = DeformConv2d(c, c, groups=4)
    k = np.asarray(params['kernel'])                       # [9, g, cg, og]
    tm.weight.data = torch.from_numpy(np.ascontiguousarray(
        np.transpose(k.reshape(3, 3, 4, 4, 4), (2, 4, 3, 0, 1)).reshape(c, 4, 3, 3)))
    tm.bias.data = torch.from_numpy(np.asarray(params['bias']))
    tm.conv_offset.forward = lambda t: torch.from_numpy(off).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _rel_close(got, want)


def test_deform_sample_plain_columns():
    """Columns at zero offsets are the 3x3 neighbourhood (zero padded);
    at whole-pixel offsets a shifted copy; bf16 in, bf16 out."""
    b, h, w, c = 1, 5, 6, 8
    x = torch.from_numpy(np.random.default_rng(25).normal(size=(b, h, w, c)).astype(np.float32))
    cols = deform_conv.deform_sample(x, torch.zeros(b, h, w, 18))
    pad = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    for t in range(9):
        dy, dx = t // 3, t % 3
        want = pad[:, dy:dy + h, dx:dx + w].reshape(b, h * w, c)
        assert torch.equal(cols[:, :, t], want)
    off = torch.zeros(b, h, w, 18)
    off[..., 8] = 2.0                    # tap 4 (the centre): dy = +2
    cols = deform_conv.deform_sample(x, off)
    want = torch.nn.functional.pad(x[:, 2:], (0, 0, 0, 0, 0, 2)).reshape(b, h * w, c)
    assert torch.equal(cols[:, :, 4], want)
    assert deform_conv.deform_sample(x.bfloat16(), off).dtype == torch.bfloat16


# ------------------------------------------------------------------ K6

def _label_points(extr, intr, hw, seed):
    """Points around the cameras (many behind one camera or the other),
    plus crafted ones: inside the 1-px border, two in one 16 x 16 cell."""
    rng = np.random.default_rng(seed)
    b = extr.shape[0]
    p = 3000
    pts = np.zeros((b, p, 8), np.float32)
    pts[..., 0] = rng.uniform(-25, 25, (b, p))
    pts[..., 1] = rng.uniform(-12, 12, (b, p))
    pts[..., 2] = rng.uniform(-3, 2, (b, p))
    h, w = hw
    k = intr[0, 0]
    cam2body = np.linalg.inv(extr[0, 0]).astype(np.float64)

    def at(u, v, d):                      # body point seen at pixel (u, v), depth d
        xc = np.array([(u - k[0, 2]) * d / k[0, 0], (v - k[1, 2]) * d / k[1, 1], d, 1.0])
        return (cam2body @ xc)[:3]
    crafted = [at(0.5, 20.5, 8.0), at(w - 0.6, 30.2, 9.0), at(40.0, 0.7, 6.0),
               at(20.3, 21.4, 7.0), at(25.7, 27.9, 5.5), at(21.0, 22.0, 0.5)]
    pts[:, :len(crafted), :3] = np.asarray(crafted, np.float32)
    mask = rng.uniform(size=(b, p)) < 0.95
    mask[:, :len(crafted)] = True
    return pts, mask


def _projection64(pts, extr, intr):
    """(u, v, depth) [N, P] in float64 of one sample's points."""
    xyz1 = np.concatenate([pts[:, :3], np.ones((len(pts), 1))], 1).astype(np.float64)
    cam = np.einsum('nij,pj->npi', extr.astype(np.float64), xyz1)
    proj = np.einsum('nij,npj->npi', intr.astype(np.float64), cam)
    return proj[..., 0] / proj[..., 2], proj[..., 1] / proj[..., 2], cam[..., 2]


def test_depth_labels_plain_matches_jax():
    """Min-depth grids within 1e-6 relative and equal one-hot labels in at
    least 99.9% of cells; each other cell is explained by a point within
    1e-4 px of a 16-px cell edge or the 1-px border, or a depth within
    1e-5 m of a bin edge."""
    hw, ds, d_bound, bins = (64, 128), 16, (2.0, 27.2, 0.5), 51
    _, intr, extr = _rig()
    pts, mask = _label_points(extr, intr, hw, seed=26)
    got_grid = depth_labels.min_depth_grid_plain(
        *(torch.from_numpy(a) for a in (pts, mask, extr, intr)), hw, ds).numpy()
    got = depth_labels.depth_labels(*(torch.from_numpy(a) for a in (pts, mask, extr, intr)),
                                    hw, ds, d_bound, bins).numpy()
    assert got.shape == (4, 4, 8, bins)
    want = np.concatenate([np.asarray(j_depth_labels.depth_labels(
        jnp.asarray(pts[i]), jnp.asarray(mask[i]), jnp.asarray(extr[i]), jnp.asarray(intr[i]),
        hw, ds, d_bound, bins)) for i in range(2)])
    # the JAX min-depth grid: its binning step swapped for the identity
    grids = []
    orig = j_depth_labels.depth_grid_to_onehot
    j_depth_labels.depth_grid_to_onehot = lambda grid, *_: grid
    try:
        for i in range(2):
            for n in range(2):
                grids.append(np.asarray(j_depth_labels.depth_labels_single_cam(
                    jnp.asarray(pts[i]), jnp.asarray(mask[i]), jnp.asarray(extr[i, n]),
                    jnp.asarray(intr[i, n]), hw, ds, d_bound, bins)))
    finally:
        j_depth_labels.depth_grid_to_onehot = orig
    want_grid = np.stack(grids).reshape(4, -1)
    empty = ~np.isfinite(want_grid)                         # JAX: +inf, the port: 1e5
    assert ((got_grid == depth_labels.EMPTY) == empty).mean() >= 0.999
    grid_ok = np.where(empty, got_grid == depth_labels.EMPTY,
                       np.abs(got_grid - want_grid) <= 1e-6 * np.abs(want_grid))
    label_ok = (got == want).all(-1).reshape(4, -1)
    ok = grid_ok & label_ok
    assert ok.mean() >= 0.999
    assert (~empty).sum() >= 8 and (got.argmax(-1) > 0).any()
    for cam, cell in zip(*np.nonzero(~ok)):
        i, n = divmod(cam, 2)
        u, v, dep = (a[n] for a in _projection64(pts[i], extr[i], intr[i]))
        near_edge = ((np.abs(u - np.round(u / ds) * ds) < 1e-4)
                     | (np.abs(v - np.round(v / ds) * ds) < 1e-4)
                     | (np.abs(u - 1) < 1e-4) | (np.abs(u - (hw[1] - 1)) < 1e-4)
                     | (np.abs(v - 1) < 1e-4) | (np.abs(v - (hw[0] - 1)) < 1e-4))
        t = (dep - (d_bound[0] - d_bound[2])) / d_bound[2]
        near_bin = np.abs(t - np.round(t)) * d_bound[2] < 1e-5
        assert (mask[i] & (near_edge | near_bin)).any(), (cam, cell)


def test_depth_labels_crafted_points():
    """The border point and the point 0.5 m in front are dropped; of two
    points in one cell the nearer wins."""
    hw, ds, d_bound, bins = (64, 128), 16, (2.0, 27.2, 0.5), 51
    _, intr, extr = _rig()
    pts, mask = _label_points(extr, intr, hw, seed=26)
    only = np.zeros_like(mask)
    only[:, :6] = True
    grid = depth_labels.min_depth_grid_plain(
        *(torch.from_numpy(a) for a in (pts, only, extr, intr)), hw, ds).numpy()
    cam0 = grid[0].reshape(4, 8)            # sample 0, camera 0 (the crafted rig)
    assert cam0[1, 1] == pytest.approx(5.5, rel=1e-5)    # (25.7, 27.9) beats (20.3, 21.4)
    assert cam0[1, 2] == depth_labels.EMPTY              # (40.0, 0.7): inside the border
    assert cam0[1, 0] == depth_labels.EMPTY              # (0.5, 20.5): inside the border
    assert cam0[1, 7] == depth_labels.EMPTY              # (w - 0.6, 30.2): inside the border
    assert (cam0 < depth_labels.EMPTY).sum() == 1


@pytest.mark.parametrize('case', ['p2_zero', 'none_kept'])
def test_depth_labels_p2_zero_and_none_kept(case):
    """A point with p2 == 0 (the division takes 1e-9 and the point lands at
    pixel (10, 20) of camera 0, depth 5: bin 7), a NaN point, and a batch
    where no point is kept (every cell in bin 0): the same labels as the
    JAX function (``exps/kernel_inputs.py::depth_label_case``)."""
    hw, ds, d_bound, bins = (64, 128), 16, (2.0, 27.2, 0.5), 51
    pts, mask, extr, intr = depth_label_case(case, hw)
    got = depth_labels.depth_labels(*(torch.from_numpy(a) for a in (pts, mask, extr, intr)),
                                    hw, ds, d_bound, bins).numpy()
    want = np.asarray(j_depth_labels.depth_labels(
        jnp.asarray(pts[0]), jnp.asarray(mask[0]), jnp.asarray(extr[0]), jnp.asarray(intr[0]),
        hw, ds, d_bound, bins))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 4, 8, bins) and (got.sum(-1) == 1).all()
    if case == 'none_kept':
        assert (got.argmax(-1) == 0).all()
    else:
        assert got[0, 1, 0].argmax() == 7                    # the p2 == 0 point
        assert (got[1].argmax(-1) > 0).sum() > 10


def test_depth_grid_to_onehot_plain_matches_jax():
    rng = np.random.default_rng(27)
    grid = rng.uniform(0, 30, (2, 3, 4, 8)).astype(np.float32)
    grid[0, 0, 0, :3] = [0.0, 1.5, 27.2]               # empty, on the lower edge, past the top
    want = np.asarray(j_depth_labels.depth_grid_to_onehot(jnp.asarray(grid), (2.0, 27.2, 0.5), 50))
    got = depth_labels.depth_grid_to_onehot(torch.from_numpy(grid), (2.0, 27.2, 0.5), 50)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ K7

@pytest.mark.parametrize('shape', [(2, 16, 32, 8), (2, 9, 13, 3)])
def test_bda_bev_warp_plain_matches_jax(shape):
    img = np.random.default_rng(28).normal(size=shape).astype(np.float32)
    bda = random_bda_matrices(shape[0], seed=29)
    assert not np.allclose(bda[:, :3, :3], np.eye(3))
    want = jwarp.bda_bev_warp(jnp.asarray(img), jnp.asarray(bda))
    got = warp.bda_bev_warp(torch.from_numpy(img), torch.from_numpy(bda))
    _rel_close(got.numpy(), want)
    mat = np.asarray(warp.bda_pixel_matrix(torch.from_numpy(bda), shape[1:3]))
    _rel_close(warp.warp_affine_nhwc(torch.from_numpy(img), torch.from_numpy(mat)).numpy(),
               jwarp.warp_affine_nhwc(jnp.asarray(img), jnp.asarray(mat)))


def _projective_mats(b, seed):
    """[B, 3, 3] src->dst pixel matrices near a rotation about a 16 x 32
    map: a random linear part, a shift of a few pixels and a small
    perspective row."""
    rng = np.random.default_rng(seed)
    m = np.eye(3) + rng.normal(0.0, 0.15, (b, 3, 3))
    m[:, :2, 2] = rng.normal(0.0, 3.0, (b, 2))
    m[:, 2] = [*rng.uniform(-4e-3, 4e-3, (2,)), 1.0]
    return m.astype(np.float32)


def test_closed_form_inverse_matches_numpy_and_jax():
    """The closed-form inverse (the adjugate over the determinant in fp32,
    the kernel's order) against ``np.linalg.inv`` in float64 and the JAX
    package's ``jnp.linalg.inv``; exact for the identity."""
    bda = random_bda_matrices(3, seed=33)
    mats = np.concatenate([_projective_mats(5, seed=32),
                           np.asarray(warp.bda_pixel_matrix(torch.from_numpy(bda), (16, 32))),
                           np.eye(3, dtype=np.float32)[None]])
    got = warp._inverse(torch.from_numpy(mats)).numpy()
    for g, m in zip(got, mats):
        _rel_close(g, np.linalg.inv(m.astype(np.float64)), tol=1e-6)
        _rel_close(g, np.asarray(jnp.linalg.inv(jnp.asarray(m))))
    np.testing.assert_array_equal(got[-1], np.eye(3))


def test_warp_affine_projective_plain_matches_jax():
    """A general projective matrix (a true homogeneous divide) through the
    closed-form inverse against the JAX warp and its ``jnp.linalg.inv``."""
    img = np.random.default_rng(34).normal(size=(5, 16, 32, 6)).astype(np.float32)
    mats = _projective_mats(5, seed=32)
    _rel_close(warp.warp_affine_nhwc(torch.from_numpy(img), torch.from_numpy(mats)).numpy(),
               jwarp.warp_affine_nhwc(jnp.asarray(img), jnp.asarray(mats)))


@pytest.mark.parametrize('n', [4, 3])
def test_bda_bev_warp_matrix_forms_match_jax(n):
    """``bda_bev_warp`` takes the [B, 4, 4] BDA matrix or its [B, 3, 3]
    block; the pixel matrix is the JAX one (``M = [lin | c - lin c]`` about
    the centre pixel, exact for the identity, which leaves the map as it
    is)."""
    img = np.random.default_rng(35).normal(size=(3, 12, 20, 5)).astype(np.float32)
    bda = random_bda_matrices(3, seed=36)[:, :n, :n]
    want = jwarp.bda_bev_warp(jnp.asarray(img), jnp.asarray(bda))
    _rel_close(warp.bda_bev_warp(torch.from_numpy(img), torch.from_numpy(bda)).numpy(), want)
    lin = bda[:, :2, :2].astype(np.float64)
    c = np.array([(20 - 1) / 2.0, (12 - 1) / 2.0])
    mat = np.asarray(warp.bda_pixel_matrix(torch.from_numpy(bda), (12, 20)))
    np.testing.assert_allclose(mat[:, :2, :2], lin, rtol=0, atol=0)
    np.testing.assert_allclose(mat[:, :2, 2], c - lin @ c, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(mat[:, 2], np.tile([0.0, 0.0, 1.0], (3, 1)))
    eye = torch.eye(n)[None].expand(3, n, n)
    np.testing.assert_array_equal(warp.bda_bev_warp(torch.from_numpy(img), eye).numpy(), img)


def test_warp_keeps_bf16_and_flip_matches_jax():
    img = np.random.default_rng(30).normal(size=(2, 8, 12, 4)).astype(np.float32)
    bda = torch.from_numpy(random_bda_matrices(2, seed=31))
    assert warp.bda_bev_warp(torch.from_numpy(img).bfloat16(), bda).dtype == torch.bfloat16
    np.testing.assert_array_equal(warp.hflip(torch.from_numpy(img)).numpy(),
                                  np.asarray(jwarp.hflip(jnp.asarray(img))))
    with pytest.raises(TypeError, match='float'):
        warp.warp_affine_nhwc(torch.zeros(1, 2, 2, 1, dtype=torch.int32), torch.eye(3)[None])


def test_deform_conv3x3_plain_matches_jax_with_an_offset_conv():
    """The fused op's plain version, fed by the port's DeformConv2d offset
    conv, against the JAX DeformConv2d applied as a whole: numpy-seeded
    parameters (the offset conv's scaled so the taps move by several
    pixels, many corners outside the 6 x 10 image) carried over by
    ``models/weights.py``, C = 16 in 4 groups, float32 within 1e-4."""
    from tests.torch_port_helpers import random_variables
    from mm_training_tpu_torch.models import weights
    b, h, w, c = 2, 6, 10, 16
    x = np.random.default_rng(31).normal(size=(b, h, w, c)).astype(np.float32)
    jm = JDeformConv2d(features=c, groups=4)
    v = random_variables(jm.init, jnp.asarray(x), seed=32)
    off = v['params']['conv_offset']
    off['kernel'] = off['kernel'] * 6.0
    off['bias'] = off['bias'] * 10.0
    want = np.asarray(jm.apply({'params': v['params']}, jnp.asarray(x)))

    tm = DeformConv2d(c, c, groups=4)
    tm.load_state_dict(weights.deform_conv_state_dict(v['params']))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        offsets = tm.conv_offset(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()
        got = deform_conv.deform_conv3x3_plain(
            xt, offsets, deform_conv.pack_weight(tm.weight, 4, torch.float32), tm.bias, 4)
        through_module = tm(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    # the offsets reach far: a share of the corners fall outside the image
    py = np.arange(h)[None, :, None, None] + (np.arange(9) // 3 - 1) + offsets[..., 0::2].numpy()
    assert ((py < 0) | (py > h - 1)).mean() > 0.2
    _rel_close(got.numpy(), want, tol=1e-4)
    assert torch.equal(through_module, got)
