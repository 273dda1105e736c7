"""The raw-rig camera path's pieces against the JAX package's, on the CPU:
the general lift-splat's plain version (kernel K8's), K8's interval
algorithm in plain PyTorch (cell order, chunks, a fixed-order combine) and
the gradient (kernel K8''s) against ``lift_splat`` and ``jax.vjp`` of it, the frustum
cells of a pitched rig against ``flat_bev_index``, the scan of a built
kernel's SASS for float atomics (on a canned listing), and the port's
``LSSFPN(factorized_splat=False)`` forward and gradients against the JAX
module on a pitched rig at narrow widths. The kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py).

Tolerances: the plain splat sums in float32 in ``index_add_``'s order,
which may differ from XLA's, so an entry is held to 1e-5 of its sum of
|terms| plus a float32 ulp (bf16: one bf16 ulp more, the final rounding);
in float64 (products in float64, sums in float32, as the JAX package under
x64) to the same. Modules match within 1e-4 of the map's scale, the
repository's module tolerance (tests/test_models/test_activation_parity.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mm_training_tpu.configs as jcfg
from mm_training_tpu.core import geometry as jgeo
from mm_training_tpu.models.lss_fpn import LSSFPN as JLSSFPN
from mm_training_tpu.ops.voxel_pooling import lift_splat as j_lift_splat
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu_torch.core import geometry as tgeo
from mm_training_tpu_torch.data import make_fake_batch
from mm_training_tpu_torch.models import weights
from mm_training_tpu_torch.models.bn_fold import BatchNorm2d
from mm_training_tpu_torch.models.lss_fpn import LSSFPN
from mm_training_tpu_torch.ops import voxel_pooling
from tests.torch_port_helpers import random_variables


def _close_to_terms(got, want, magnitude, tol=1e-5, ulp_bits=None):
    """Each entry within ``tol`` of its sum of |terms| plus a float32 ulp,
    and with ``ulp_bits`` one ulp of that many significant bits more."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = tol * np.asarray(magnitude, np.float64) + 1.2e-7 * np.abs(want)
    if ulp_bits is not None:
        a = np.abs(want)
        bound += np.where(a == 0, 0.0, 2.0 ** (np.floor(np.log2(np.where(a == 0, 1, a)))
                                                - (ulp_bits - 1)))
    worst = float((np.abs(got - want) - bound).max())
    assert worst <= 0.0, worst


def _splat_case(seed, m=3, d=20, p=24, c=16, n_cells=40):
    """depth [M, D, P] uniform, ctx [M, P, C] normal, idx [M, D, P] with
    whole bins and scattered rows in the trash cell ``n_cells``."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0, 1, (m, d, p)).astype(np.float32)
    ctx = rng.normal(size=(m, p, c)).astype(np.float32)
    idx = rng.integers(0, n_cells + 1, (m, d, p)).astype(np.int32)
    idx[:, :2] = n_cells
    return depth, ctx, idx, n_cells


def _magnitude(depth, ctx, idx, n_cells):
    """Each output entry's sum of |terms|, float64."""
    return voxel_pooling.lift_splat_plain(torch.from_numpy(np.abs(depth)).double(),
                                          torch.from_numpy(np.abs(ctx)).double(),
                                          torch.from_numpy(idx), n_cells).numpy()


def test_lift_splat_plain_matches_jax_fp32():
    depth, ctx, idx, n_cells = _splat_case(50)
    assert (idx == n_cells).mean() > 0.1
    want = np.asarray(j_lift_splat(jnp.asarray(depth), jnp.asarray(ctx), jnp.asarray(idx),
                                   n_cells))
    got = voxel_pooling.lift_splat(torch.from_numpy(depth), torch.from_numpy(ctx),
                                   torch.from_numpy(idx), n_cells)
    assert got.dtype == torch.float32 and got.shape == (3, n_cells, 16)
    _close_to_terms(got.numpy(), want, _magnitude(depth, ctx, idx, n_cells))


def test_lift_splat_plain_matches_jax_bf16():
    """bf16 inputs: the rows are bf16 products (as the JAX slab), the sums
    float32, the result bf16."""
    depth, ctx, idx, n_cells = _splat_case(51)
    jd, jc = jnp.asarray(depth, jnp.bfloat16), jnp.asarray(ctx, jnp.bfloat16)
    want = j_lift_splat(jd, jc, jnp.asarray(idx), n_cells)
    assert want.dtype == jnp.bfloat16
    td = torch.from_numpy(np.array(jd.astype(jnp.float32))).bfloat16()
    tc = torch.from_numpy(np.array(jc.astype(jnp.float32))).bfloat16()
    got = voxel_pooling.lift_splat(td, tc, torch.from_numpy(idx), n_cells)
    assert got.dtype == torch.bfloat16
    _close_to_terms(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                    _magnitude(td.float().numpy(), tc.float().numpy(), idx, n_cells),
                    ulp_bits=8)


def test_lift_splat_plain_rounds_each_product_to_bf16():
    """A cell that sums two nearly cancelling rows, d c and -(d + u) c (u
    one bf16 ulp of d): the exact sum is -u c, while each product's bf16
    rounding moves it by up to 2^-9 |d c|, a large share of that. The plain
    version gives JAX's bits; the same sums of unrounded float32 products
    miss them by more than a bf16 ulp in most cells."""
    rng = np.random.default_rng(52)
    m, p, c = 2, 64, 16
    d1 = torch.from_numpy(rng.uniform(0.5, 1.0, (m, p)).astype(np.float32)).bfloat16()
    depth = torch.stack([d1, -(d1.float() + 2.0 ** -8).bfloat16()], 1)   # [M, 2, P]
    ctx = torch.from_numpy(rng.normal(size=(m, p, c)).astype(np.float32)).bfloat16()
    idx = torch.arange(p, dtype=torch.int32).expand(m, 2, p).contiguous()  # cell = pixel
    want = j_lift_splat(jnp.asarray(depth.float().numpy(), jnp.bfloat16),
                        jnp.asarray(ctx.float().numpy(), jnp.bfloat16),
                        jnp.asarray(idx.numpy()), p)
    want = np.asarray(want.astype(jnp.float32))
    got = voxel_pooling.lift_splat(depth, ctx, idx, p)
    np.testing.assert_array_equal(got.float().numpy(), want)
    unrounded = voxel_pooling.lift_splat_plain(depth.float(), ctx.float(), idx, p)
    unrounded = unrounded.bfloat16().float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
    assert (np.abs(unrounded - want) > ulp).mean() > 0.5


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_lift_splat_backward_plain_matches_jax_vjp(dtype):
    """d depth and d ctx against ``jax.vjp`` of ``lift_splat``; trash rows
    get no depth gradient. In float64 (JAX with x64 on for this test) the
    products are float64 and the cell sums float32 in both."""
    depth, ctx, idx, n_cells = _splat_case(53)
    depth, ctx = depth.astype(dtype), ctx.astype(dtype)
    g = np.random.default_rng(54).normal(size=(depth.shape[0], n_cells, ctx.shape[-1]))
    g = g.astype(dtype)
    x64 = jax.config.jax_enable_x64
    jax.config.update('jax_enable_x64', dtype == np.float64)
    try:
        _, vjp = jax.vjp(lambda a, b: j_lift_splat(a, b, jnp.asarray(idx), n_cells),
                         jnp.asarray(depth), jnp.asarray(ctx))
        want_depth, want_ctx = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    finally:
        jax.config.update('jax_enable_x64', x64)
    assert want_depth.dtype == dtype
    t = [torch.from_numpy(a) for a in (g, depth, ctx, idx)]
    got_depth, got_ctx = voxel_pooling.lift_splat_backward(*t, n_cells)
    assert got_depth.dtype == got_ctx.dtype == t[1].dtype
    mag_depth, _ = voxel_pooling.lift_splat_backward_plain(
        t[0].abs().double(), t[1].double(), t[2].abs().double(), t[3], n_cells)
    _, mag_ctx = voxel_pooling.lift_splat_backward_plain(
        t[0].abs().double(), t[1].abs().double(), t[2].double(), t[3], n_cells)
    _close_to_terms(got_depth.numpy(), want_depth, mag_depth.numpy())
    _close_to_terms(got_ctx.numpy(), want_ctx, mag_ctx.numpy())
    assert not got_depth.numpy()[idx == n_cells].any()
    # autograd through the wrapper on CPU tensors is the same plain version
    dep, cx = t[1].clone().requires_grad_(), t[2].clone().requires_grad_()
    voxel_pooling.lift_splat(dep, cx, t[3], n_cells).backward(t[0])
    assert torch.equal(dep.grad, got_depth) and torch.equal(cx.grad, got_ctx)


# ------------------------------------------------------- K8's intervals

def _pitched_tiny_cells():
    """The tiny camera rig (2 frames x 2 cameras, 51 bins x 4 x 8 pixels, a
    16 x 32 BEV) pitched by 3 degrees: its raw splat index [4, 51, 32] and
    n_cells (464 non-empty cells, up to 44 entries a cell)."""
    cfg = tcfg.tiny_test_config(use_cam=True)
    bb = cfg.get_backbone_conf()
    s2e, intr = _pitched_rig(cfg, 2)
    with torch.device('meta'):
        lss = LSSFPN(bb)
    idx = lss.raw_splat_indices(torch.from_numpy(s2e), torch.from_numpy(intr))
    return idx.numpy(), int(np.prod(bb.bev_hw))


def _inputs(depth, ctx, dtype):
    """(JAX arrays, torch tensors) of ``dtype`` ('float32' or 'bfloat16')
    holding the same values."""
    jd, jc = (jnp.asarray(a, getattr(jnp, dtype)) for a in (depth, ctx))
    td, tc = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
              for a in (jd, jc))
    return jd, jc, td, tc


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('chunk', [1, 7, 256])
def test_lift_splat_intervals_plain_matches_jax_on_the_pitched_rig(dtype, chunk):
    """K8's algorithm (count, offsets, scatter into cell order, chunk sums,
    their fixed-order combine) against ``lift_splat`` on the pitched tiny
    rig's own cells: at chunk 1 every entry is a chunk, at 7 cells of up
    to 44 entries take up to 7 chunks, at 256 one. Within 1e-5 of each
    entry's sum of |terms| (one bf16 ulp more in bf16)."""
    idx, n_cells = _pitched_tiny_cells()
    rng = np.random.default_rng(56)
    depth = rng.uniform(0, 1, idx.shape).astype(np.float32)
    ctx = rng.normal(size=(idx.shape[0], idx.shape[2], 16)).astype(np.float32)
    jd, jc, td, tc = _inputs(depth, ctx, dtype)
    want = np.asarray(j_lift_splat(jd, jc, jnp.asarray(idx), n_cells).astype(jnp.float32))
    got = voxel_pooling.lift_splat_intervals_plain(td, tc, torch.from_numpy(idx), n_cells, chunk)
    assert got.dtype == tc.dtype and got.shape == (4, n_cells, 16)
    _close_to_terms(got.float().numpy(), want,
                    _magnitude(td.float().numpy(), tc.float().numpy(), idx, n_cells),
                    ulp_bits=8 if dtype == 'bfloat16' else None)
    counts = np.bincount((idx + (n_cells + 1) * np.arange(4)[:, None, None]).ravel())
    assert counts.reshape(4, n_cells + 1)[:, :n_cells].max() > 7 * 5


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('chunk', [1, 7, 256])
def test_lift_splat_intervals_plain_rounds_each_product(dtype, chunk):
    """Cells that each sum two nearly cancelling rows, d c and -(d + u) c
    (u one ulp of d in the dtype), among rows that fill other cells: each
    product rounded to the dtype before the float32 sum gives JAX's bits in
    every cell, whichever chunk the two rows fall in."""
    rng = np.random.default_rng(57)
    m, p, c = 2, 64, 16
    d1 = rng.uniform(0.5, 1.0, (m, p)).astype(np.float32)
    jd1 = jnp.asarray(d1, getattr(jnp, dtype))
    ulp = 2.0 ** -8 if dtype == 'bfloat16' else 2.0 ** -24
    jd2 = -(jd1.astype(jnp.float32) + ulp).astype(getattr(jnp, dtype))
    depth = np.stack([np.asarray(jd1.astype(jnp.float32)), np.asarray(jd2.astype(jnp.float32)),
                      rng.uniform(0, 1, (m, p)).astype(np.float32)], 1)      # [M, 3, P]
    ctx = rng.normal(size=(m, p, c)).astype(np.float32)
    idx = np.stack([np.arange(p), np.arange(p), p + np.arange(p) % 5], 0)
    idx = np.broadcast_to(idx, (m, 3, p)).astype(np.int32).copy()       # cell = pixel
    jd, jc, td, tc = _inputs(depth, ctx, dtype)
    want = np.asarray(j_lift_splat(jd, jc, jnp.asarray(idx), p + 5).astype(jnp.float32))
    got = voxel_pooling.lift_splat_intervals_plain(td, tc, torch.from_numpy(idx), p + 5, chunk)
    np.testing.assert_array_equal(got[:, :p].float().numpy(), want[:, :p])
    _close_to_terms(got.float().numpy(), want,
                    _magnitude(td.float().numpy(), tc.float().numpy(), idx, p + 5),
                    ulp_bits=8 if dtype == 'bfloat16' else None)


@pytest.mark.parametrize('chunk', [7, 256])
def test_lift_splat_intervals_plain_one_cell_and_all_trash(chunk):
    """Every row of camera 0 in one cell (its longest interval), every row of
    camera 1 trash (zeros), camera 2 random cells, in bf16: against
    ``lift_splat`` within its bound, the empty cells exactly zero."""
    rng = np.random.default_rng(58)
    m, d, p, c, n_cells = 3, 40, 50, 16, 30
    depth = rng.uniform(0, 1, (m, d, p)).astype(np.float32)
    ctx = rng.normal(size=(m, p, c)).astype(np.float32)
    idx = rng.integers(0, n_cells + 1, (m, d, p)).astype(np.int32)
    idx[0], idx[1] = 17, n_cells
    jd, jc, td, tc = _inputs(depth, ctx, 'bfloat16')
    want = np.asarray(j_lift_splat(jd, jc, jnp.asarray(idx), n_cells).astype(jnp.float32))
    got = voxel_pooling.lift_splat_intervals_plain(td, tc, torch.from_numpy(idx), n_cells,
                                                   chunk).float().numpy()
    _close_to_terms(got, want, _magnitude(td.float().numpy(), tc.float().numpy(), idx, n_cells),
                    ulp_bits=8)
    assert not got[1].any() and not np.delete(got[0], 17, 0).any() and got[0, 17].any()


def test_raw_interval_stats_of_the_pitched_rig():
    """``exps/kernel_inputs.py::raw_interval_stats`` (printed by the card's
    smoke run beside K8) against numpy's count of each (camera, cell)."""
    from mm_training_tpu_torch.exps.kernel_inputs import raw_interval_stats
    idx, n_cells = _pitched_tiny_cells()
    got = raw_interval_stats(torch.from_numpy(idx), n_cells)
    counts = np.stack([np.bincount(c.ravel(), minlength=n_cells + 1)[:n_cells] for c in idx])
    full = counts[counts > 0]
    assert got == {'kept_rows': int((idx < n_cells).sum()), 'cells': 4 * n_cells,
                   'non_empty_cells': full.size, 'max': int(full.max()),
                   'p99': pytest.approx(float(np.quantile(full, 0.99))),
                   'mean_non_empty': pytest.approx(float(full.mean()))}
    assert got['max'] == 44 and got['non_empty_cells'] == 464


# a cuobjdump -sass listing cut down: two instantiations of K8, one of K8'
_SASS = '''
\tcode for sm_90a
\t\tFunction : _ZN40_GLOBAL__N__lift_splat_raw_cu_5d2c_021lift_splat_raw_kernelI13__nv_bfloat16EEvNS_6ParamsE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   ATOMS.ADD R4, [R2], R3 ;
        /*0020*/                   REDG.E.ADD.64.STRONG.GPU desc[UR4][R2.64], R4 ;
        /*0030*/                   FADD.FTZ R0, R1, R2 ;
\t\tFunction : _ZN40_GLOBAL__N__lift_splat_raw_cu_5d2c_025lift_splat_raw_bwd_kernelIfLi16EEEvNS_9BwdParamsE
        /*0000*/              @P0 REDG.E.ADD.F32x4.FTZ.RN.STRONG.GPU desc[UR4][R2.64], R4 ;
\t\tFunction : _ZN40_GLOBAL__N__lift_splat_raw_cu_5d2c_021lift_splat_raw_kernelIfEEvNS_6ParamsE
        /*0000*/                   RED.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R5 ;
        /*0010*/                   ATOMG.E.ADD.BF16x2.RN.STRONG.GPU PT, R0, [R2.64], R5 ;
'''


def test_float_atomics_reads_each_kernels_sass(monkeypatch):
    """``ops/build.py::float_atomics``, which the card's tests and smoke
    run use to show that K8 has no float atomic, on a canned SASS listing:
    it counts the float atomics and reductions (global, shared, any width)
    of each function that holds the kernel's name, and none of its integer
    atomics or float arithmetic; it raises when no function matches."""
    import subprocess
    from pathlib import Path
    from mm_training_tpu_torch.ops import build
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=_SASS, stderr='')

    monkeypatch.setattr(build, 'cuda_tool', lambda name='nvcc': name)
    monkeypatch.setattr(build.subprocess, 'run', run)
    got = build.float_atomics('lift_splat_raw', 'lift_splat_raw_kernel', Path('k8.so'))
    assert calls == [['cuobjdump', '-sass', 'k8.so']]
    assert list(got.values()) == [0, 2] and all('raw_kernelI' in k for k in got)
    assert list(build.float_atomics('lift_splat_raw', 'lift_splat_raw_bwd_kernel',
                                    Path('k8.so')).values()) == [1]
    with pytest.raises(RuntimeError, match='no function'):
        build.float_atomics('lift_splat_raw', 'lift_splat_kernel', Path('k8.so'))


# ------------------------------------------------------------------ geometry

def _pitched_rig(cfg, b, pitch_deg=3.0):
    batch = make_fake_batch(cfg, batch_size=b, seed=20, pitch_deg=pitch_deg)
    return batch['sensor2ego'][:, 0], batch['intrin'][:, 0]


def test_pitched_fake_rig_is_the_jax_tests_rig():
    """``make_fake_batch(pitch_deg=3)`` pitches every camera as the JAX
    trainer's test does (sensor2ego @ R_x(3 deg), the extrinsics its
    inverse); the rig is then not row-independent, for both packages."""
    from scipy.spatial.transform import Rotation
    from mm_training_tpu.data.fake_batch import make_fake_batch as j_fake_batch
    cfg = tcfg.tiny_test_config(use_cam=True)
    got = make_fake_batch(cfg, seed=0, pitch_deg=3.0)
    want = j_fake_batch(jcfg.tiny_test_config(use_cam=True), seed=0)
    pitch = np.eye(4)
    pitch[:3, :3] = Rotation.from_euler('x', 3.0, degrees=True).as_matrix()
    s2e = (want['sensor2ego'] @ pitch).astype(np.float32)
    np.testing.assert_allclose(got['sensor2ego'], s2e, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got['extrinsics'], np.linalg.inv(s2e), rtol=0, atol=1e-6)
    for k in ('imgs', 'intrin', 'points', 'gt_boxes'):
        np.testing.assert_array_equal(got[k], want[k])
    assert not tgeo.rig_is_row_independent(got['sensor2ego'], got['intrin'])
    assert not jgeo.rig_is_row_independent(got['sensor2ego'], got['intrin'])
    assert tgeo.rig_is_row_independent(want['sensor2ego'], want['intrin'])


def test_flat_bev_index_on_a_pitched_rig_matches_jax():
    """The cells of every frustum point of the pitched production rig (4
    cameras of 704 x 1280, d_bound (2.0, 206.4, 0.5), 1.6 m cells, one z
    cell of -5..3 m) against the JAX chain compiled: equal in at least
    99.9% of points; where the frameworks' last-ulp rounding moves a point
    across a cell edge, into a neighbouring cell or across the grid's edge
    only. The pitch makes a point's cell depend on its image row, and z
    sends some in-range (x, y) points to the trash cell."""
    cfg = tcfg.lidar_cam_radar(batch_size=1)
    bb = cfg.get_backbone_conf()
    assert bb.d_bound == (2.0, 206.4, 0.5)
    s2e, intr = _pitched_rig(cfg, 1)
    lss = LSSFPN.__new__(LSSFPN)
    lss.conf = bb
    vc, vs, vn = lss.bev_geometry()
    fr = tgeo.create_frustum(bb.d_bound, bb.final_dim, bb.downsample_factor)

    def cells(fr, s2e, intr):
        g = jgeo.quantize_geometry(jgeo.get_geometry(fr, s2e, intr), vc, vs)
        return jgeo.flat_bev_index(g, vn), g
    want, jidx = (np.asarray(a) for a in jax.jit(cells)(jnp.asarray(fr), jnp.asarray(s2e),
                                                         jnp.asarray(intr)))
    tg = tgeo.quantize_geometry(tgeo.get_geometry(torch.from_numpy(fr), torch.from_numpy(s2e),
                                                  torch.from_numpy(intr)), vc, vs)
    got = tgeo.flat_bev_index(tg, vn).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (1, 4, 409, 44, 80)
    nx, ny, nz = vn
    n_cells = nx * ny
    x, y, z = jidx[..., 0], jidx[..., 1], jidx[..., 2]
    in_xy = (x >= 0) & (x < nx) & (y >= 0) & (y < ny)
    assert (in_xy & ((z < 0) | (z >= nz))).any()          # z-range trash
    assert 0 < (want < n_cells).mean() < 1
    # row-dependent cells: the factorized splat's row-0 cells would be wrong
    kept = (want < n_cells)[..., 1:, :] & (want < n_cells)[..., :-1, :]
    assert (want[..., 1:, :] != want[..., :-1, :])[kept].any()
    diff = got != want
    assert diff.mean() <= 1e-3, diff.mean()
    g, w = got[diff], want[diff]
    inside = (g < n_cells) & (w < n_cells)
    assert (np.abs(g[inside] // nx - w[inside] // nx) <= 1).all()
    assert (np.abs(g[inside] % nx - w[inside] % nx) <= 1).all()
    lss_idx = LSSFPN(bb).raw_splat_indices(torch.from_numpy(s2e), torch.from_numpy(intr))
    np.testing.assert_array_equal(lss_idx.numpy(), got.reshape(4, 409, 44 * 80))


# ------------------------------------------------------------------ LSSFPN

def _backbone_conf(cfgmod):
    """The tiny camera geometry (2 cameras of 64 x 128, 50 bins) with an
    image ResNet-10, DepthNet mid width 32 and the raw-rig splat."""
    return dataclasses.replace(
        cfgmod.tiny_test_config(use_cam=True).get_backbone_conf(), factorized_splat=False,
        img_backbone_conf=cfgmod.ImageBackboneConf(depth=10),
        depth_net_conf=cfgmod.DepthNetConf(in_channels=512, mid_channels=32))


def _lss_state_dict(v):
    p, s = v['params'], v['batch_stats']
    out = weights.resnet_state_dict(p['img_backbone'], s['img_backbone'], 4,
                                    prefix='img_backbone.', depth=10, stem_s2d=True)
    out.update(weights.second_fpn_state_dict(p['img_neck'], s['img_neck'],
                                             (0.25, 0.5, 1, 2), prefix='img_neck.'))
    out.update(weights.depth_net_state_dict(p['depth_net'], s['depth_net'],
                                            prefix='depth_net.'))
    return out


# the reduce conv's bias exists in the port (the reference's name; zero from
# the JAX init) and not in the flax ConvBN: no JAX gradient to compare
NO_JAX_GRADIENT = ('depth_net.reduce_conv.0.bias',)


@pytest.fixture(scope='module')
def lss_case():
    """The pitched tiny rig (2 frames x 2 cameras, one image flipped), random
    images, random flax variables (the DCN's offset conv scaled up, so its
    taps leave the pixel grid) and a random cotangent of the BEV."""
    jbb = _backbone_conf(jcfg)
    assert not jbb.factorized_splat
    batch = make_fake_batch(tcfg.tiny_test_config(use_cam=True), seed=10, pitch_deg=3.0)
    rng = np.random.default_rng(11)
    imgs = rng.normal(size=batch['imgs'].shape).astype(np.float32)
    flipped = np.zeros(4, bool)
    flipped[1] = True
    jm = JLSSFPN(jbb)
    args = [jnp.asarray(a) for a in (imgs, batch['sensor2ego'], batch['intrin'], flipped)]
    v = random_variables(jm.init, *args, seed=12)
    v['params']['depth_net']['dcn']['conv_offset']['kernel'] *= 8.0
    cot = rng.normal(size=(2, 16, 32, 80)).astype(np.float32)
    return dict(batch=batch, imgs=imgs, flipped=flipped, jm=jm, args=args, v=v, cot=cot)


def test_lss_fpn_raw_rig_forward_matches_jax(lss_case):
    """The raw-rig LSSFPN (the general splat of each camera's D x fH x fW
    frustum points, summed over cameras), with and without the depth
    oracle, against the JAX module on the pitched rig: BEV and depth within
    1e-4 of the map's scale; the factorized splat on the same rig is
    measurably wrong."""
    c = lss_case
    t_args = [torch.from_numpy(np.asarray(a)) for a in c['args']]
    tm = LSSFPN(_backbone_conf(tcfg))
    tm.load_state_dict(_lss_state_dict(c['v']), strict=True)
    tm.eval()
    oracle = np.eye(51, dtype=np.float32)[np.random.default_rng(13).integers(0, 50, (4, 4, 8))]
    for o in (None, oracle):
        want_bev, want_depth = jax.jit(functools.partial(c['jm'].apply, train=False))(
            c['v'], *c['args'], None if o is None else jnp.asarray(o))
        with torch.no_grad():
            bev, depth = tm(*t_args, None if o is None else torch.from_numpy(o))
        assert bev.shape == (2, 16, 32, 80)
        scale = max(1.0, float(np.abs(want_bev).max()))
        assert np.abs(bev.numpy() - want_bev).max() <= 1e-4 * scale
        assert np.abs(depth.permute(0, 2, 3, 1).numpy() - want_depth).max() <= 1e-4
    factorized = LSSFPN(dataclasses.replace(tm.conf, factorized_splat=True))
    factorized.load_state_dict(tm.state_dict())
    factorized.eval()
    with torch.no_grad():
        wrong, _ = factorized(*t_args)
    assert np.abs(wrong.numpy() - want_bev).max() > 1e-2 * scale


def test_lss_fpn_raw_rig_gradients_match_jax(lss_case):
    """The vjp of the raw-rig LSSFPN (eval mode, no oracle, so the softmax
    depth reaches the splat) for a random cotangent of the BEV: the
    gradients of the images and of every conv parameter within 1e-4 of
    each tensor's largest entry of the JAX module's ``jax.vjp``."""
    c = lss_case
    jm, v = c['jm'], c['v']

    def f(params, imgs):
        return jm.apply({'params': params, 'batch_stats': v['batch_stats']}, imgs,
                        *c['args'][1:], None, train=False)[0]
    _, vjp = jax.vjp(jax.jit(f), v['params'], c['args'][0])
    j_params, j_imgs = vjp(jnp.asarray(c['cot']))
    want = {k: t.numpy() for k, t in _lss_state_dict(
        {'params': jax.tree_util.tree_map(np.asarray, j_params),
         'batch_stats': v['batch_stats']}).items()}

    tm = LSSFPN(_backbone_conf(tcfg))
    tm.load_state_dict(_lss_state_dict(v), strict=True)
    tm.eval()
    imgs = torch.from_numpy(c['imgs']).requires_grad_()
    bev, _ = tm(imgs, *(torch.from_numpy(np.asarray(a)) for a in c['args'][1:]))
    names, params = zip(*tm.named_parameters())
    grads = torch.autograd.grad(bev, (imgs,) + params, torch.from_numpy(c['cot']),
                                allow_unused=True)

    def close(got, want, name):
        top = float(np.abs(want).max())
        assert top > 0, name
        assert np.abs(got - want).max() <= 1e-4 * top, name
    close(grads[0].numpy(), np.asarray(j_imgs), 'imgs')
    bns = {n for n, m in tm.named_modules() if isinstance(m, BatchNorm2d)}
    checked = 0
    for name, g in zip(names, grads[1:]):
        if name in NO_JAX_GRADIENT:
            continue
        if g is None:
            # eval-mode BatchNorm applies its cached affine (models/bn_fold.py):
            # no gradient reaches its scale and shift here; the train-step
            # parity files hold those in train mode
            assert name.rsplit('.', 1)[0] in bns, name
            continue
        close(g.numpy(), want[name], name)
        checked += 1
    assert checked > 30
