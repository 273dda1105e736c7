"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
false. No JAX here, so the file runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from mm_training_tpu_torch.ops import affine_act, circle_nms, gaussian, voxelize

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (CUDA kernels have no CPU mode)')
    return torch.Generator(device='cuda').manual_seed(0)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(1, 64, 64, 512), (2, 3, 5, 7)])
def test_affine_act_kernel_equals_plain(gen, dtype, shape):
    def rand(*s):
        return torch.randn(*s, generator=gen, device='cuda')
    x = rand(*shape).to(dtype).contiguous(memory_format=torch.channels_last)
    r = rand(*shape).to(dtype).contiguous(memory_format=torch.channels_last)
    s, t = rand(shape[1]), rand(shape[1])
    for res in (None, r):
        for relu in (True, False):
            got = affine_act.affine_act(x, s, t, res, relu)
            # same fp32 steps, one rounding: bit for bit
            assert torch.equal(got, affine_act.affine_act_plain(x, s, t, res, relu))


def test_voxelize_kernel_matches_plain(gen):
    pc, vs, grid = (-204.8, -25.6, -5.0, 204.8, 25.6, 3.0), (0.2, 0.2, 8.0), (256, 2048)
    lo = torch.tensor([pc[0], pc[1], pc[2], 0, -10, 0, 0, 0], device='cuda')
    hi = torch.tensor([pc[3], pc[4], pc[5], 1, 10, 40, 1, 0.1], device='cuda')
    pts = lo + torch.rand(2, 100_000, 8, generator=gen, device='cuda') * (hi - lo)
    mask = torch.rand(2, 100_000, generator=gen, device='cuda') < 0.95
    for cap in (None, 2):
        got = voxelize.voxelize_pillars_dense(pts, mask, pc, vs, grid,
                                              max_points_per_voxel=cap)
        m = mask if cap is None else voxelize._first_k_mask(pts, mask, pc, vs, grid, cap)
        want = voxelize.voxelize_pillars_dense_plain(pts, m, pc, vs, grid)
        # atomics add in no fixed order: fp32 rounding of sums up to ~40
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_circle_nms_kernel_equals_plain(gen):
    for rows, k in ((4, 500), (3, 1024), (2, 37)):
        c = torch.rand(rows, k, 2, generator=gen, device='cuda') * 30
        sc = torch.rand(rows, k, generator=gen, device='cuda')
        va = torch.rand(rows, k, generator=gen, device='cuda') < 0.9
        th = torch.tensor([4.0, 10.0, 0.5, 0.25][:rows], device='cuda')
        assert torch.equal(circle_nms.circle_nms_mask(c, sc, va, th),
                           circle_nms.circle_nms_mask_plain(c, sc, va, th))
    with pytest.raises(ValueError, match='K <= 1024'):
        circle_nms.circle_nms_mask(c.repeat(1, 30, 1), sc.repeat(1, 30),
                                   va.repeat(1, 30), th)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(4, 64, 64, 512), (2, 3, 5, 7), (2, 160, 16, 32)])
def test_affine_act_backward_kernel_matches_plain(gen, dtype, shape):
    def rand(*s):
        return torch.randn(*s, generator=gen, device='cuda')
    def cl(t):
        return t.to(dtype).contiguous(memory_format=torch.channels_last)
    x, r, g = cl(rand(*shape)), cl(rand(*shape)), cl(rand(*shape))
    s, t = rand(shape[1]), rand(shape[1])
    for res in (None, r):
        for relu in (True, False):
            got = affine_act.affine_act_backward(g, x, s, t, res, relu)
            want = affine_act.affine_act_backward_plain(g, x, s, t, res, relu)
            # dx, dr: the same products, one rounding: bit for bit
            assert torch.equal(got[0], want[0])
            if res is not None:
                assert torch.equal(got[1], want[1])
            # ds, dt: fp32 sums over N*H*W in another order
            n = x.numel() // shape[1]
            for a, b in zip(got[2:], want[2:]):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * n)
            # deterministic: a second launch gives the same bits
            again = affine_act.affine_act_backward(g, x, s, t, res, relu)
            assert all(torch.equal(a, b) for a, b in zip(got[2:], again[2:]))


def test_affine_act_autograd_reaches_the_backward_kernel(gen):
    x = torch.randn(2, 64, 8, 16, generator=gen, device='cuda').to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    s = torch.randn(64, generator=gen, device='cuda', requires_grad=True)
    t = torch.randn(64, generator=gen, device='cuda', requires_grad=True)
    before = affine_act.affine_act_backward.launches
    affine_act.AffineAct.apply(x, s, t, None, True).float().sum().backward()
    assert affine_act.affine_act_backward.launches == before + 1
    assert x.grad is not None and s.grad is not None and t.grad is not None


def test_draw_heatmap_kernel_matches_plain(gen):
    for b, m, k, hw in ((4, 4, 500, (64, 512)), (2, 3, 37, (24, 40))):
        h, w = hw
        cx = torch.randint(-3, w + 3, (b, k), generator=gen, device='cuda')
        cy = torch.randint(-3, h + 3, (b, k), generator=gen, device='cuda')
        centers = torch.stack([cx, cy], -1).int()
        radii = torch.randint(0, 12, (b, k), generator=gen, device='cuda').int()
        valid = torch.rand(b, m, k, generator=gen, device='cuda') < 0.5
        got = gaussian.draw_heatmap(centers, radii, valid, hw)
        want = gaussian.draw_heatmap_plain(centers, radii, valid, hw)
        # expf and torch.exp may differ by an ulp; centres are exactly 1.0
        assert torch.equal(got == 1.0, want == 1.0)
        assert (got - want).abs().max().item() <= 1e-6


def _splat_outside_tolerance(got, want, magnitude):
    """Entries of a bf16 splat further from the plain version than one bf16
    ulp of it plus the fp32 atomic-order bound, 1e-5 of the entry's sum of
    |terms| (``magnitude``): where a cell's sum cancels, fp32 sums in
    another order may round to bf16 values several ulps apart."""
    w = want.float()
    ulp = torch.where(w == 0, 0.0, torch.exp2(torch.floor(torch.log2(w.abs())) - 7))
    return int(((got.float() - w).abs() > ulp + 1e-5 * magnitude).sum())


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_lift_splat_kernel_matches_plain(gen, dtype):
    """K4 at the camera path's shapes (4 cameras, 409 bins, 44 x 80, C = 80,
    8192 cells): the fp32 sums to atomic-order rounding, one bf16 ulp after
    the cast (plus that rounding where a sum cancels); trash-bin rows are
    dropped."""
    from mm_training_tpu_torch.ops import voxel_pooling
    m, d, fh, fw, c, g = 4, 409, 44, 80, 80, 8192
    depth = torch.rand(m, d, fh, fw, generator=gen, device='cuda').softmax(1).to(dtype)
    ctx = torch.randn(m, fh, fw, c, generator=gen, device='cuda').to(dtype)
    idx = torch.randint(0, g + 1, (m, d, fw), generator=gen, device='cuda').int()
    idx[:, :100] = g
    zvalid = torch.rand(m, d, fh, fw, generator=gen, device='cuda') < 0.6
    got = voxel_pooling.lift_splat_factorized(depth, ctx, idx, zvalid, g)
    want = voxel_pooling.lift_splat_factorized_plain(depth, ctx, idx, zvalid, g)
    assert got.dtype == dtype and got.shape == (m, g, c)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        mag = voxel_pooling.lift_splat_factorized_plain(depth.float(), ctx.float().abs(), idx,
                                                        zvalid, g)
        assert _splat_outside_tolerance(got, want, mag) == 0
    with pytest.raises(NotImplementedError, match='backward'):
        voxel_pooling.lift_splat_factorized(depth.float().requires_grad_(), ctx.float(),
                                            idx, zvalid, g)


@pytest.mark.parametrize('dtype,c', [(torch.bfloat16, 512), (torch.float32, 512),
                                     (torch.bfloat16, 12)])
def test_deform_sample_kernel_equals_plain(gen, dtype, c):
    """K5 at the DepthNet's shape (4 x 44 x 80 x 512) and at a channel count
    below a 16-byte vector: offsets of up to 3 px, a quarter snapped to
    whole pixels; the same roundings, so bit for bit."""
    from mm_training_tpu_torch.ops import deform_conv
    x = torch.randn(4, 44, 80, c, generator=gen, device='cuda').to(dtype)
    off = torch.rand(4, 44, 80, 18, generator=gen, device='cuda') * 6 - 3
    snap = torch.rand(off.shape, generator=gen, device='cuda') < 0.25
    off = torch.where(snap, off.round(), off)
    got = deform_conv.deform_sample(x, off)
    assert got.dtype == dtype and got.shape == (4, 44 * 80, 9, c)
    assert torch.equal(got, deform_conv.deform_sample_plain(x, off))


def test_depth_labels_kernel_equals_plain(gen):
    """K6 on a lidar_cam_radar request (100k points, 4 cameras of 704 x
    1280, 409 bins) and on the binning of a precomputed grid: bit for bit
    (the same fp32 steps; the minimum does not depend on the order)."""
    from mm_training_tpu_torch.configs import lidar_cam_radar
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.ops import depth_labels
    cfg = lidar_cam_radar(batch_size=2)
    batch = make_fake_batch(cfg, seed=0)
    pts, mask, extr, intr = (torch.as_tensor(batch[k], device='cuda') for k in
                             ('points', 'point_mask', 'extrinsics', 'intrin'))
    bb = cfg.get_backbone_conf()
    args = (pts, mask, extr[:, 0].contiguous(), intr[:, 0].contiguous(), cfg.final_dim,
            bb.downsample_factor, bb.d_bound, bb.depth_channels)
    got = depth_labels.depth_labels(*args)
    want = depth_labels.depth_labels_plain(*args)
    assert got.shape == (8, 44, 80, 409)
    assert torch.equal(got, want)
    assert (got.argmax(-1) > 0).sum() > 1000          # many cells hold a depth
    grid = torch.rand(3, 44, 80, generator=gen, device='cuda') * 220
    grid[0, 0, :3] = torch.tensor([0.0, 1.5, 206.4])
    assert torch.equal(depth_labels.depth_grid_to_onehot(grid, bb.d_bound, 409),
                       depth_labels.depth_grid_to_onehot_plain(grid, bb.d_bound, 409))


@pytest.mark.parametrize('dtype,c', [(torch.bfloat16, 80), (torch.float32, 80),
                                     (torch.float32, 3)])
def test_bev_warp_kernel_equals_plain(gen, dtype, c):
    """K7 at the camera BEV's shape (B=2 x 32 x 256 x 80) with rotated,
    flipped and scaled augmentations: the plain version's fp32 steps
    without FMA contraction, so bit for bit."""
    from mm_training_tpu_torch.data import random_bda_matrices
    from mm_training_tpu_torch.ops import warp
    img = torch.randn(2, 32, 256, c, generator=gen, device='cuda').to(dtype)
    bda = torch.as_tensor(random_bda_matrices(2, seed=1), device='cuda')
    assert not torch.allclose(bda[:, :3, :3], torch.eye(3, device='cuda'))
    got = warp.bda_bev_warp(img, bda)
    mat = warp.bda_pixel_matrix(bda, (32, 256))
    assert got.dtype == dtype
    assert torch.equal(got, warp.warp_affine_nhwc_plain(img, mat))
