"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
false. Every device-op count runs in a fresh interpreter
(``exps/timing.py::device_ops_in_child``): in one process that has launched
many kernels, torch.profiler sessions have come back without device events.
No JAX here, so the file runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from mm_training_tpu_torch.exps.kernel_inputs import (HEATMAP_CASES, depth_label_case,
                                                      heatmap_case)
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


def _nms_rows(gen, rows, k):
    """Unsorted random rows, with (where there are enough rows) one row of
    equal scores, one of identical centres, one with no valid slot, and
    centres on a 0.5 m grid in the rest so that distances tie with the
    thresholds."""
    c = torch.rand(rows, k, 2, generator=gen, device='cuda') * 30
    sc = torch.rand(rows, k, generator=gen, device='cuda')
    va = torch.rand(rows, k, generator=gen, device='cuda') < 0.9
    if rows > 1:
        sc[1] = 0.5
    if rows > 2:
        c[2] = c[2, :1]
    if rows > 3:
        va[3] = False
    if rows > 4:
        c[4:] = (c[4:] * 2).round() / 2
    return c, sc, va


@pytest.mark.parametrize('k', [1, 31, 32, 33, 500, 1000, 1024])
def test_circle_nms_cluster_kernel_equals_plain(gen, k):
    """K3 (one cluster launch a call: sort, bitmask, sweep, scatter) against
    the plain version at row lengths around the 32-box chunks and up to
    1024, 1-16 rows, with float, per-task tuple and [R] tensor thresholds."""
    for rows in (1, 4, 16):
        c, sc, va = _nms_rows(gen, rows, k)
        per_task = (4.0, 10.0, 0.5, 0.25)[:rows]
        for th in (1.0, per_task, torch.rand(rows, generator=gen, device='cuda') * 10):
            before = circle_nms.circle_nms_mask.launches
            got = circle_nms.circle_nms_mask(c, sc, va, th)
            assert circle_nms.circle_nms_mask.launches == before + 1
            assert torch.equal(got, circle_nms.circle_nms_mask_plain(c, sc, va, th))
    # a strided view of the boxes, as the decode passes it
    boxes = torch.rand(4, k, 9, generator=gen, device='cuda') * 30
    assert torch.equal(circle_nms.circle_nms_mask(boxes[..., :2], sc[:4], va[:4], per_task),
                       circle_nms.circle_nms_mask_plain(boxes[..., :2].contiguous(), sc[:4],
                                                        va[:4], per_task))
    with pytest.raises(ValueError, match='K <= 1024'):
        circle_nms.circle_nms_mask(torch.zeros(1, 1025, 2, device='cuda'),
                                   torch.zeros(1, 1025, device='cuda'),
                                   torch.ones(1, 1025, dtype=torch.bool, device='cuda'), 1.0)


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


def _backward_case(gen, shape, dtype):
    def cl():
        return torch.randn(*shape, generator=gen, device='cuda').to(dtype).contiguous(
            memory_format=torch.channels_last)
    s = torch.randn(shape[1], generator=gen, device='cuda')
    t = torch.randn(shape[1], generator=gen, device='cuda')
    return cl(), cl(), cl(), s, t


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(4, 2048, 22, 40), (3, 1024, 5, 7), (2, 12, 9, 11),
                                   (2, 7, 3, 5), (1, 2048, 1, 1), (1, 64, 1, 1),
                                   (2, 64, 9, 11)])
def test_affine_act_backward_any_channel_count(gen, dtype, shape):
    """A' at ResNet-50's last-stage shape (C = 2048) and at C = 1024, 12, 7
    (below or not a multiple of a 16-byte vector), at a single pixel and at
    pixel counts that are no multiple of a block's rows (C = 64: 32 rows a
    block, 198 pixels): one launch a call; dx, dr bit for bit, ds, dt to
    fp32 order; the sums bit-equal on a second call, also after a call of
    another shape has used the partials' scratch and the barrier words."""
    x, r, g, s, t = _backward_case(gen, shape, dtype)
    other = _backward_case(gen, (4, 96, 33, 40), dtype)
    n = x.numel() // shape[1]
    for res in (None, r):
        for relu in (True, False):
            before = affine_act.affine_act_backward.launches
            got = affine_act.affine_act_backward(g, x, s, t, res, relu)
            assert affine_act.affine_act_backward.launches == before + 1
            want = affine_act.affine_act_backward_plain(g, x, s, t, res, relu)
            assert torch.equal(got[0], want[0])
            if res is not None:
                assert torch.equal(got[1], want[1])
            for a, b in zip(got[2:], want[2:]):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * n)
            affine_act.affine_act_backward(other[2], other[0], other[3], other[4],
                                           other[1] if res is not None else None, relu)
            again = affine_act.affine_act_backward(g, x, s, t, res, relu)
            assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)


@pytest.mark.parametrize('case', ('random',) + HEATMAP_CASES)
def test_draw_heatmap_kernel_matches_plain(gen, case):
    """K2 on random windows (centres up to 3 cells off the map, 500 and 37
    slots) and on the edge cases of ``exps/kernel_inputs.py::heatmap_case``
    (band edges, off-map centres, r = 0, radii beyond the map, a map with
    no valid object, 1,500 slots, rows off 16 bytes): within 1e-6 of the
    plain version with the centres equal, the same bits on a second call,
    one device kernel a call."""
    from mm_training_tpu_torch.exps.timing import device_ops_in_child
    if case == 'random':
        cases = []
        for b, m, k, hw in ((4, 4, 500, (64, 512)), (2, 3, 37, (24, 40))):
            h, w = hw
            cx = torch.randint(-3, w + 3, (b, k), generator=gen, device='cuda')
            cy = torch.randint(-3, h + 3, (b, k), generator=gen, device='cuda')
            cases.append((torch.stack([cx, cy], -1).int(),
                          torch.randint(0, 12, (b, k), generator=gen, device='cuda').int(),
                          torch.rand(b, m, k, generator=gen, device='cuda') < 0.5, hw))
    else:
        centers, radii, valid, hw = heatmap_case(case)
        cases = [(*(torch.from_numpy(a).cuda() for a in (centers, radii, valid)), hw)]
    for centers, radii, valid, hw in cases:
        got = gaussian.draw_heatmap(centers, radii, valid, hw)
        want = gaussian.draw_heatmap_plain(centers, radii, valid, hw)
        # expf and torch.exp may differ by an ulp; centres are exactly 1.0
        assert torch.equal(got == 1.0, want == 1.0)
        assert (got - want).abs().max().item() <= 1e-6
        assert torch.equal(gaussian.draw_heatmap(centers, radii, valid, hw), got)
        if case == 'no_valid_map':
            assert not got[:, 1].any()
    ops, = device_ops_in_child([[('ops.gaussian', 'draw_heatmap', (centers, radii, valid, hw),
                                  {})]])
    assert sum(ops.values()) == 1 and any('heatmap_kernel' in k for k in ops), ops


def _splat_outside_tolerance(got, want, magnitude):
    """Entries of a bf16 splat further from the plain version than one bf16
    ulp of it plus the fp32 atomic-order bound, 1e-5 of the entry's sum of
    |terms| (``magnitude``): where a cell's sum cancels, fp32 sums in
    another order may round to bf16 values several ulps apart."""
    w = want.float()
    ulp = torch.where(w == 0, 0.0, torch.exp2(torch.floor(torch.log2(w.abs())) - 7))
    return int(((got.float() - w).abs() > ulp + 1e-5 * magnitude).sum())


def _check_splat(got, depth, ctx, idx, zvalid, g):
    """K4 against its plain version: a cell sums up to hundreds of rows in
    fp32 atomics of no fixed order, so fp32 is held to 1e-5 of each entry's
    sum of |terms|, and bf16 to one ulp plus that."""
    from mm_training_tpu_torch.ops import voxel_pooling
    want = voxel_pooling.lift_splat_factorized_plain(depth, ctx, idx, zvalid, g)
    assert got.dtype == depth.dtype and got.shape == want.shape
    mag = voxel_pooling.lift_splat_factorized_plain(depth.float(), ctx.float().abs(), idx,
                                                    zvalid, g)
    if depth.dtype == torch.float32:
        assert int(((got - want).abs() > 1e-5 * mag).sum()) == 0
    else:
        assert _splat_outside_tolerance(got, want, mag) == 0


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('layout', ['channels_last', 'slice', 'nchw'])
@pytest.mark.parametrize('batch_size', [1, 4])
def test_lift_splat_kernel_on_the_rig_indices(gen, dtype, layout, batch_size):
    """K4 on the fake rig's own splat indices at the B=1 and B=4 requests'
    shapes (4 and 16 cameras), depth and ctx handed over as the path hands
    them (strided views, read in place): one launch, within the atomic-order
    bound of the plain version. The adds the kernel counts on the card: each
    kept row x C once, and one 16-byte add per 4 channels of each run of
    consecutive bins bound for one cell within a 64-bin task tile, fewer
    than a quarter of the scalar adds."""
    from mm_training_tpu_torch.configs import lidar_cam_radar
    from mm_training_tpu_torch.exps.kernel_inputs import splat_inputs
    from mm_training_tpu_torch.ops import voxel_pooling
    depth, ctx, idx, zvalid, g = splat_inputs(lidar_cam_radar(batch_size=batch_size), gen,
                                              layout, dtype)
    assert not ctx.is_contiguous()
    before = voxel_pooling.lift_splat_factorized.launches
    got = voxel_pooling.lift_splat_factorized(depth, ctx, idx, zvalid, g)
    assert voxel_pooling.lift_splat_factorized.launches == before + 1
    _check_splat(got, depth, ctx, idx, zvalid, g)
    c = ctx.shape[-1]
    cells = idx.cpu().numpy()
    kept = cells < g
    start = kept.copy()
    start[:, 1:] &= (cells[:, 1:] != cells[:, :-1]) | (np.arange(1, cells.shape[1]) % 64 == 0
                                                       )[None, :, None]
    scalar, vector = voxel_pooling.splat_atomic_adds(depth, ctx, idx, zvalid, g)
    assert (scalar, vector) == (int(kept.sum()) * c, int(start.sum()) * c // 4)
    assert 0 < vector * 4 < scalar


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('m,d,fh,fw,c', [(2, 70, 13, 11, 16), (1, 5, 44, 3, 80),
                                         (3, 129, 64, 17, 96), (2, 20, 30, 9, 128),
                                         (1, 1, 1, 1, 8)])
def test_lift_splat_kernel_ragged_tiles(gen, dtype, m, d, fh, fw, c):
    """K4 where D, fW and fH are no multiple of the 64-bin, 4-column and
    16-row tiles, with runs of equal cells along the bins (crossing a tile
    edge), a non-contiguous ctx and an NCHW depth; then every row in the
    trash cell: zeros."""
    from mm_training_tpu_torch.ops import voxel_pooling
    n_cells = 50
    depth = torch.randn(m, d, fh, fw, generator=gen, device='cuda').softmax(1).to(dtype)
    ctx = torch.randn(m, fw, fh, c, generator=gen, device='cuda').to(dtype).transpose(1, 2)
    runs = torch.randint(0, n_cells + 1, (m, (d + 2) // 3, fw), generator=gen, device='cuda')
    idx = runs.repeat_interleave(3, dim=1)[:, :d].int().contiguous()
    zvalid = torch.rand(m, d, fh, fw, generator=gen, device='cuda') < 0.7
    got = voxel_pooling.lift_splat_factorized(depth, ctx, idx, zvalid, n_cells)
    _check_splat(got, depth, ctx, idx, zvalid, n_cells)
    trash = torch.full_like(idx, n_cells)
    out = voxel_pooling.lift_splat_factorized(depth, ctx, trash, zvalid, n_cells)
    assert out.shape == (m, n_cells, c) and not out.float().abs().max().item()


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


# (case, image, downsample, depth bounds, bins): the requests' own points and
# rig; the crafted two-camera rig (a point with p2 == 0, a NaN point) with
# rows of 3 and 5 bins (row ends off 16 bytes) and a 32 x 48 image (2 x 3
# cells); the same points with none kept; a 256 x 256-cell grid, too large
# for one CTA's shared memory, so split over the cluster
DEPTH_LABEL_CASES = {
    'request_b2': ('request', None, None, None, None),
    'request_b4': ('request', None, None, None, None),
    'p2_zero_d3': ('p2_zero', (64, 128), 16, (2.0, 50.0, 16.0), 3),
    'p2_zero_d5': ('p2_zero', (64, 128), 16, (2.0, 50.0, 8.0), 5),
    'tiny_image': ('p2_zero', (32, 48), 16, (2.0, 206.4, 0.5), 409),
    'none_kept_d5': ('none_kept', (64, 128), 16, (2.0, 50.0, 8.0), 5),
    'split_grid': ('p2_zero', (1024, 1024), 4, (2.0, 50.0, 8.0), 5),
}


@pytest.mark.parametrize('case', list(DEPTH_LABEL_CASES))
def test_depth_labels_kernel_equals_plain(gen, case):
    """K6 on a lidar_cam_radar request (100k points, 4 cameras of 704 x
    1280, 409 bins) at B=2 and B=4 (16 cameras, 92 MB of labels; the
    matrices strided views, as the path hands them over), and on the
    crafted rig at 3 and 5 bins, a tiny image, a NaN point and no kept
    point; then the binning of a precomputed grid of the same cells: bit
    for bit (the same fp32 steps; the minimum does not depend on the
    order), the same bits on a second call, one device kernel a call."""
    from mm_training_tpu_torch.configs import lidar_cam_radar
    from mm_training_tpu_torch.exps.kernel_inputs import depth_label_inputs
    from mm_training_tpu_torch.exps.timing import device_ops_in_child
    from mm_training_tpu_torch.ops import depth_labels
    kind, hw, ds, d_bound, bins = DEPTH_LABEL_CASES[case]
    if kind == 'request':
        cfg = lidar_cam_radar(batch_size=int(case[-1]))
        args = depth_label_inputs(cfg, 'cuda', seed=0)
        hw, ds, d_bound, bins = args[4:]
    else:
        args = (*(torch.from_numpy(a).cuda() for a in depth_label_case(kind, hw)), hw, ds,
                d_bound, bins)
    got = depth_labels.depth_labels(*args)
    want = depth_labels.depth_labels_plain(*args)
    m = args[2].shape[0] * args[2].shape[1]
    assert got.shape == (m, hw[0] // ds, hw[1] // ds, bins)
    assert torch.equal(got, want)
    assert torch.equal(depth_labels.depth_labels(*args), got)
    cells = (got.argmax(-1) > 0).sum().item()
    if kind == 'request':
        assert cells > 500 * m                        # many cells hold a depth
    else:
        assert (cells == 0) == (kind == 'none_kept')
    grid = torch.rand(m, *got.shape[1:3], generator=gen, device='cuda') * 220
    grid.view(-1)[:3] = torch.tensor([0.0, 1.5, 206.4])
    onehot = depth_labels.depth_grid_to_onehot(grid, d_bound, bins)
    assert torch.equal(onehot, depth_labels.depth_grid_to_onehot_plain(grid, d_bound, bins))
    ops, grid_ops = device_ops_in_child(
        [[('ops.depth_labels', 'depth_labels', tuple(args), {})],
         [('ops.depth_labels', 'depth_grid_to_onehot', (grid, d_bound, bins), {})]])
    assert sum(ops.values()) == 1 and any('depth_labels_kernel' in k for k in ops), ops
    assert sum(grid_ops.values()) == 1 and any('depth_onehot_kernel' in k for k in grid_ops), \
        grid_ops


def test_depth_labels_refuses_a_grid_beyond_one_cluster(gen):
    from mm_training_tpu_torch.ops import depth_labels
    pts, mask, extr, intr = (torch.from_numpy(a).cuda() for a in depth_label_case('p2_zero'))
    side = int(depth_labels.max_cells(pts.device) ** 0.5) + 1
    with pytest.raises(ValueError, match='cluster'):
        depth_labels.depth_labels(pts, mask, extr, intr, (side, side), 1, (2.0, 50.0, 8.0), 5)


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


def test_k3_and_k7_are_one_device_kernel_a_call(gen):
    """torch.profiler sees one device operation (no copy, no fill) in a call
    of each redesigned wrapper, at the paths' shapes: two kernels, one of
    each name, in a profiler session over one call of each."""
    from mm_training_tpu_torch.data import random_bda_matrices
    from mm_training_tpu_torch.exps.timing import device_ops_in_child
    c, sc, va = _nms_rows(gen, 4, 500)
    bev = torch.randn(1, 32, 256, 80, generator=gen, device='cuda').bfloat16()
    bda = torch.as_tensor(random_bda_matrices(1, seed=3), device='cuda')
    ops, = device_ops_in_child([[('ops.circle_nms', 'circle_nms_mask',
                                  (c, sc, va, (4, 10, 0.5, 0.25)), {}),
                                 ('ops.warp', 'bda_bev_warp', (bev, bda), {})]])
    assert sorted(ops.values()) == [1, 1], ops
    assert any('circle_nms' in n for n in ops) and any('bev_warp' in n for n in ops), ops


def test_affine_act_backward_and_lift_splat_device_ops(gen):
    """torch.profiler over one A' call ([4,64,64,512] bf16 with a residual)
    and one K4 call (the B=1 camera request's shapes): A' is one device
    kernel, K4 at most two, with no copy or fill beside them."""
    from mm_training_tpu_torch.configs import lidar_cam_radar
    from mm_training_tpu_torch.exps.kernel_inputs import splat_inputs
    from mm_training_tpu_torch.exps.timing import device_ops_in_child
    x, r, g, s, t = _backward_case(gen, (4, 64, 64, 512), torch.bfloat16)
    splat = splat_inputs(lidar_cam_radar(batch_size=1), gen)
    ops, = device_ops_in_child([[('ops.affine_act', 'affine_act_backward',
                                  (g, x, s, t, r, True), {}),
                                 ('ops.voxel_pooling', 'lift_splat_factorized', tuple(splat),
                                  {})]])
    backward = sum(n for name, n in ops.items() if 'affine_act_bwd' in name)
    k4 = sum(n for name, n in ops.items() if 'splat' in name)
    other = sum(ops.values()) - backward - k4
    assert backward == 1 and other == 0 and 1 <= k4 <= 2, ops


def test_backward_kernels_device_ops(gen):
    """torch.profiler over one call each: the DCN's whole backward K5' at
    the B=1 camera train step's shape ([4, 44, 80, 512] bf16, 4 groups) is
    at most three device ops, all its own kernels (no fill, copy, column
    kernel or bmm), K4' at the B=1 camera splat one kernel."""
    from mm_training_tpu_torch.configs import lidar_cam_radar
    from mm_training_tpu_torch.exps.kernel_inputs import deform_inputs, splat_inputs
    from mm_training_tpu_torch.exps.timing import device_ops_in_child
    x, off, wgt, bias = deform_inputs((4, 44, 80, 512), 4, gen)
    dy = torch.randn(4, 44, 80, 512, generator=gen, device='cuda').bfloat16()
    depth, ctx, idx, zvalid, n = splat_inputs(lidar_cam_radar(batch_size=1), gen)
    g = torch.randn(idx.shape[0], n, ctx.shape[-1], generator=gen, device='cuda').bfloat16()
    ops, splat_ops = device_ops_in_child(
        [[('ops.deform_conv', 'deform_conv3x3_backward', (dy, x, off, wgt, bias, 4), {})],
         [('ops.voxel_pooling', 'lift_splat_factorized_backward',
           (g, depth, ctx, idx, zvalid, n), {})]])
    assert sum(ops.values()) <= 3 and all('deform_bwd' in n for n in ops), ops
    assert list(splat_ops.values()) == [1] and 'lift_splat_bwd' in next(iter(splat_ops)), \
        splat_ops


def test_warp_backward_and_raw_splat_are_one_device_kernel_a_call(gen):
    """torch.profiler over one call each at the camera paths' shapes: K7'
    (the BEV warp's gradient, [1, 32, 256, 80] bf16 under a rotated BDA),
    K8 and K8' (the B=1 raw-rig splat) are one device kernel each, with no
    fill, copy or rounding kernel beside them."""
    from mm_training_tpu_torch.configs import lidar_cam_radar
    from mm_training_tpu_torch.data import random_bda_matrices
    from mm_training_tpu_torch.exps.kernel_inputs import raw_splat_inputs
    from mm_training_tpu_torch.exps.timing import device_ops_in_child
    img = torch.randn(1, 32, 256, 80, generator=gen, device='cuda').bfloat16()
    bda = torch.as_tensor(random_bda_matrices(1, seed=3), device='cuda')
    depth, ctx, idx, n = raw_splat_inputs(lidar_cam_radar(batch_size=1), gen)
    g = torch.randn(idx.shape[0], n, ctx.shape[-1], generator=gen, device='cuda').bfloat16()
    counted = device_ops_in_child(
        [[('ops.warp', 'warp_backward', (img, img, bda, 4), {})],
         [('ops.voxel_pooling', 'lift_splat', (depth, ctx, idx, n), {})],
         [('ops.voxel_pooling', 'lift_splat_backward', (g, depth, ctx, idx, n), {})]])
    for ops, name in zip(counted, ('bev_warp_bwd', 'lift_splat_raw_kernel',
                                   'lift_splat_raw_bwd')):
        assert list(ops.values()) == [1] and name in next(iter(ops)), ops

# ------------------------------------------------- K5 fused, K1 into the encoder

@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape,groups,max_offset', [
    ((4, 44, 80, 512), 4, 3.0),      # the B=1 camera request's DCN
    ((2, 13, 21, 64), 4, 3.0),       # ragged H and W against the 8 x 16 pixel tile
    ((2, 12, 20, 64), 4, 9.0),       # corners beyond the halo and outside the image
    ((1, 9, 17, 512), 2, 2.0),       # two tiles of 128 output channels a group
])
def test_deform_conv3x3_kernel_matches_plain(gen, dtype, shape, groups, max_offset):
    """The fused K5 against its plain version (sampling, grouped product,
    one rounding, the bias): the sampled A-tiles are the plain columns bit
    for bit, the fp32 sums run in another order than the plain version's,
    so each output (and the plain version's) must be the op's rounding of
    some sum within 1e-5 of the sum of |terms| of the exact sum
    (``exps/kernel_inputs.py::deform_outside_tolerance``). Offsets beyond
    the 3 px halo read their corners from L2."""
    from mm_training_tpu_torch.exps.kernel_inputs import deform_inputs, deform_outside_tolerance
    from mm_training_tpu_torch.ops import deform_conv
    x, off, weight, bias = deform_inputs(shape, groups, gen, dtype, max_offset)
    before = deform_conv.deform_conv3x3.launches
    got = deform_conv.deform_conv3x3(x, off, weight, bias, groups)
    assert deform_conv.deform_conv3x3.launches == before + 1
    assert got.dtype == dtype and got.shape == shape
    outside, err = deform_outside_tolerance(got, x, off, weight, bias, groups)
    assert outside == 0, err
    from_l2, corners = deform_conv.halo_corners(x, off, weight, bias, groups)
    assert corners == 4 * 9 * shape[0] * shape[1] * shape[2]
    assert (from_l2 > 0) == (max_offset > 3.0), (from_l2, corners)


def test_deform_conv2d_forward_runs_the_fused_kernel(gen):
    """``DeformConv2d.forward`` on the card launches the fused kernel and
    no column kernel, and matches the module run through the plain
    version; its packed kernel is laid out once per parameter state."""
    from unittest import mock
    from mm_training_tpu_torch.exps.kernel_inputs import deform_outside_tolerance
    from mm_training_tpu_torch.models.depth_net import DeformConv2d
    from mm_training_tpu_torch.ops import deform_conv
    m = DeformConv2d(64, 64, groups=4)
    m.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        m.conv_offset.weight.normal_(0, 0.05)
    m = m.to('cuda', torch.bfloat16).to(memory_format=torch.channels_last)
    x = torch.randn(2, 64, 12, 20, generator=gen, device='cuda').bfloat16().contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        cols_before = deform_conv.deform_sample.launches
        got = m(x)
        packed = m.packed_weight(torch.bfloat16)
        assert m.packed_weight(torch.bfloat16) is packed
        assert deform_conv.deform_sample.launches == cols_before
        off = m.conv_offset(x).permute(0, 2, 3, 1).float()
        with mock.patch.object(deform_conv, 'deform_conv3x3', deform_conv.deform_conv3x3_plain):
            want = m(x)
    assert got.shape == want.shape == (2, 64, 12, 20)
    outside, err = deform_outside_tolerance(got.permute(0, 2, 3, 1), x.permute(0, 2, 3, 1),
                                            off, packed, m.bias, 4)
    assert outside == 0, err


def _k1_points(gen, b, p=100_000):
    pc, vs, grid = (-204.8, -25.6, -5.0, 204.8, 25.6, 3.0), (0.2, 0.2, 8.0), (256, 2048)
    lo = torch.tensor([pc[0] - 5, pc[1] - 2, pc[2] - 1, 0, -10, 0, 0, 0], device='cuda')
    hi = torch.tensor([pc[3] + 5, pc[4] + 2, pc[5] + 1, 1, 10, 40, 1, 0.1], device='cuda')
    pts = lo + torch.rand(b, p, 8, generator=gen, device='cuda') * (hi - lo)
    mask = torch.rand(b, p, generator=gen, device='cuda') < 0.95
    return pts, mask, (pc, vs, grid)


def _k1_outside_tolerance(got, want):
    """Entries further than one bf16 ulp plus K1's atomic-order slack (the
    fp32 means agree to 1e-5) from the plain version."""
    w = want.float()
    ulp = torch.where(w == 0, 0.0, torch.exp2(torch.floor(torch.log2(w.abs())) - 7))
    if want.dtype == torch.float32:
        ulp = torch.zeros_like(ulp)
    return int(((got.float() - w).abs() > ulp + 1e-5 * (1 + w.abs())).sum())


@pytest.mark.parametrize('batch_size', [1, 4])
@pytest.mark.parametrize('s2d,channels', [(True, 20), (True, 24), (True, 32), (False, 5),
                                          (False, 8)])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_pillar_encoder_input_kernel_matches_plain(gen, batch_size, s2d, channels, dtype):
    """K1's encoder-input entry at B=1 and B=4 (100k points a frame, the
    full 256 x 2048 grid, some points outside it): the means, one rounding,
    the space-to-depth channel order and the zero pad, in one launch."""
    from mm_training_tpu_torch.ops import voxelize
    pts, mask, geo = _k1_points(gen, batch_size)
    before = voxelize.pillar_encoder_input.launches
    got = voxelize.pillar_encoder_input(pts, mask, *geo, num_features=5, dtype=dtype,
                                        space_to_depth=s2d, channels=channels)
    assert voxelize.pillar_encoder_input.launches == before + 1
    want = voxelize.pillar_encoder_input_plain(pts, mask, *geo, num_features=5, dtype=dtype,
                                               space_to_depth=s2d, channels=channels)
    assert got.dtype == dtype and got.shape == want.shape
    assert got.shape == ((batch_size, 128, 1024, channels) if s2d
                         else (batch_size, 256, 2048, channels))
    assert _k1_outside_tolerance(got, want) == 0
    used = 20 if s2d else 5
    assert torch.equal(got[..., used:], torch.zeros_like(got[..., used:]))
    assert got[..., :used].abs().sum() > 0


def test_pillar_encoder_input_empty_and_out_of_range(gen):
    """No masked-in point, and every point outside the grid: all zeros, the
    pad included; calls in turn at other batch sizes and layouts each see
    their own points only (the launch zeroes its accumulator); K1's entry is
    one device op a call."""
    from mm_training_tpu_torch.exps.timing import device_ops_in_child
    from mm_training_tpu_torch.ops import voxelize
    pts, mask, geo = _k1_points(gen, 2, 5000)
    empty = torch.zeros_like(mask)
    far = pts.clone()
    far[..., 0] += 1000.0
    for p, m in ((pts, empty), (far, mask)):
        got = voxelize.pillar_encoder_input(p, m, *geo, dtype=torch.bfloat16, channels=24)
        assert got.shape == (2, 128, 1024, 24) and not got.any()
    for p, m in ((pts, mask), (pts[:1], mask[:1]), (pts, mask), (pts, mask)):
        for s2d, nf in ((True, 5), (False, 8)):
            got = voxelize.pillar_encoder_input(p, m, *geo, num_features=nf,
                                                dtype=torch.float32, space_to_depth=s2d)
            want = voxelize.pillar_encoder_input_plain(p, m, *geo, num_features=nf,
                                                       dtype=torch.float32, space_to_depth=s2d)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    ops, = device_ops_in_child([[('ops.voxelize', 'pillar_encoder_input', (pts, mask, *geo),
                                  dict(dtype=torch.bfloat16, channels=24))]])
    assert list(ops.values()) == [1] and 'pillar' in next(iter(ops)), ops


# ------------------------------------------------- the backward kernels K4', K5', K7'

@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('layout', ['channels_last', 'nchw'])
@pytest.mark.parametrize('batch_size', [1, 4])
def test_lift_splat_backward_kernel_matches_plain(gen, dtype, layout, batch_size):
    """K4' at the B=1 and B=4 camera paths' shapes on the fake rig's own
    indices, depth in the layouts the path hands over (with and without the
    oracle): one launch, d depth and d ctx within 1e-5 of each entry's sum
    of |terms| of the float32 plain version (one bf16 ulp more in bf16), the
    same bits on a second call (``exps/backward_checks.py``)."""
    from mm_training_tpu_torch.configs import lidar_cam_radar
    from mm_training_tpu_torch.exps.backward_checks import splat_backward_errors
    from mm_training_tpu_torch.exps.kernel_inputs import splat_inputs
    from mm_training_tpu_torch.ops import voxel_pooling
    depth, ctx, idx, zvalid, n = splat_inputs(lidar_cam_radar(batch_size=batch_size), gen,
                                              layout, dtype)
    g = torch.randn(idx.shape[0], n, ctx.shape[-1], generator=gen, device='cuda').to(dtype)
    before = voxel_pooling.lift_splat_factorized_backward.launches
    errors = splat_backward_errors(depth, ctx, idx, zvalid, n, g)
    assert voxel_pooling.lift_splat_factorized_backward.launches == before + 2
    assert errors['ok'], errors


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('m,d,fh,fw,c', [(2, 70, 13, 11, 16), (1, 33, 64, 3, 128),
                                         (3, 5, 1, 2, 8)])
def test_lift_splat_backward_kernel_ragged(gen, dtype, m, d, fh, fw, c):
    """K4' where D is no multiple of its 32-bin tile, fH reaches 64, C 128,
    with a non-contiguous ctx and an expanded (stride-0) output gradient, as
    the camera sum's backward hands it over; trash-cell rows read zero."""
    from mm_training_tpu_torch.exps.backward_checks import splat_backward_errors
    n_cells = 40
    depth = torch.randn(m, d, fh, fw, generator=gen, device='cuda').softmax(1).to(dtype)
    ctx = torch.randn(m, fw, fh, c, generator=gen, device='cuda').to(dtype).transpose(1, 2)
    idx = torch.randint(0, n_cells + 1, (m, d, fw), generator=gen, device='cuda').int()
    zvalid = torch.rand(m, d, fh, fw, generator=gen, device='cuda') < 0.7
    g = torch.randn(1, n_cells, c, generator=gen, device='cuda').to(dtype).expand(m, n_cells, c)
    errors = splat_backward_errors(depth, ctx, idx, zvalid, n_cells, g)
    assert errors['ok'], errors


@pytest.mark.parametrize('dtype,c', [(torch.bfloat16, 80), (torch.float32, 80),
                                     (torch.float32, 3), (torch.bfloat16, 3)])
@pytest.mark.parametrize('batch_size', [1, 4])
def test_bev_warp_backward_kernel_matches_plain(gen, dtype, c, batch_size):
    """K7' at the camera BEV's shape (32 x 256) under rotated, flipped and
    scaled augmentations, from the BDA matrix (``bda_bev_warp``) and from a
    projective pixel matrix (``warp_affine_nhwc``): within 1e-5 of each
    entry's sum of |terms| of the float32 plain version (float32 atomics in
    no fixed order; one bf16 ulp more in bf16)."""
    from mm_training_tpu_torch.data import random_bda_matrices
    from mm_training_tpu_torch.exps.backward_checks import warp_backward_errors
    from mm_training_tpu_torch.ops import warp
    img = torch.randn(batch_size, 32, 256, c, generator=gen, device='cuda').to(dtype)
    g = torch.randn(img.shape, generator=gen, device='cuda').to(dtype)
    bda = torch.as_tensor(random_bda_matrices(batch_size, seed=3), device='cuda')
    proj = warp.bda_pixel_matrix(bda, (32, 256))
    proj[:, 2, :2] = torch.rand(batch_size, 2, generator=gen, device='cuda') * 4e-4 - 2e-4
    for mat, n in ((bda, 4), (bda[:, :3, :3], 3), (proj, 0)):
        errors = warp_backward_errors(img, mat, n, g)
        assert errors['ok'], (n, errors)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape,groups,max_offset', [
    ((4, 44, 80, 512), 4, 3.0),      # the B=1 camera path's DCN
    ((4, 44, 80, 512), 4, 0.0),      # the same at whole pixels (the zero-initialised offset conv)
    ((2, 13, 21, 64), 4, 9.0),       # ragged, corners beyond the halo and far outside the image
    ((1, 9, 17, 32), 2, 0.0),        # every sample on a whole pixel
    ((1, 5, 6, 16), 2, 1.5),         # C/g = C_out/g = 8, one tile not full
])
def test_deform_conv_backward_kernel_matches_plain(gen, dtype, shape, groups, max_offset):
    """K5', the DCN's whole backward (two launches a call, no column
    tensor): d x and d offsets within 1e-5 of each entry's sum of |terms| of
    the plain transposed sampling of the float32 d cols, plus one rounding
    of each d cols entry (bf16: one ulp more, and the corner weights' bf16
    rounding); d weight and d bias within a rounding of their largest entry
    of autograd through the plain forward in float64; d offsets, d weight and d bias
    the same bits on a second call (``exps/backward_checks.py``). At whole
    pixels the offsets' gradient is the one-sided difference, not zero."""
    from mm_training_tpu_torch.exps.backward_checks import deform_backward_errors
    from mm_training_tpu_torch.exps.kernel_inputs import deform_inputs
    from mm_training_tpu_torch.ops import deform_conv
    x, off, weight, bias = deform_inputs(shape, groups, gen, dtype, max_offset)
    dy = torch.randn(*shape[:3], weight.shape[0] * weight.shape[2], generator=gen,
                     device='cuda').to(dtype)
    before = (deform_conv.deform_conv3x3_backward.launches, deform_conv.deform_sample.launches)
    errors = deform_backward_errors(x, off, weight, bias, groups, dy)
    assert (deform_conv.deform_conv3x3_backward.launches,
            deform_conv.deform_sample.launches) == (before[0] + 2, before[1])
    assert errors['ok'], errors


# ------------------------------------------------- gradient requests through autograd
# Last in the file: after the port's kernels have launched from autograd's
# device thread, later torch.profiler sessions of a process have come back
# without device events (PERF.md section 7), so every test that counts
# device ops runs before these.

def test_deform_conv3x3_one_device_op_and_refusals(gen):
    """One fused K5 call at the B=1 request's shape is one device kernel (no
    column, copy or fill beside it); a weight of another dtype and C/g off a
    multiple of 8 raise; a gradient request is taken now (DeformConv: the
    fused forward, then K5' once, no columns kernel), and refused before the
    forward where K5' does not take C_out/g (above 128)."""
    from mm_training_tpu_torch.exps.kernel_inputs import deform_inputs
    from mm_training_tpu_torch.exps.timing import device_ops_in_child
    from mm_training_tpu_torch.ops import deform_conv
    x, off, weight, bias = deform_inputs((4, 44, 80, 512), 4, gen)
    ops, = device_ops_in_child([[('ops.deform_conv', 'deform_conv3x3', (x, off, weight, bias, 4),
                                  {})]])
    assert list(ops.values()) == [1] and 'deform_conv' in next(iter(ops)), ops
    xg = x.float().requires_grad_()
    before = (deform_conv.deform_sample.launches, deform_conv.deform_conv3x3_backward.launches)
    deform_conv.deform_conv3x3(xg, off, weight.float(), bias.float(), 4).sum().backward()
    assert (deform_conv.deform_sample.launches,
            deform_conv.deform_conv3x3_backward.launches) == (before[0], before[1] + 1)
    assert xg.grad.shape == x.shape
    x2, off2, w2, b2 = deform_inputs((1, 9, 17, 512), 2, gen)
    fwd = deform_conv.deform_conv3x3.launches
    with pytest.raises(ValueError, match='C_out/g up to 128'):
        deform_conv.deform_conv3x3(x2.requires_grad_(), off2, w2, b2, 2)
    assert deform_conv.deform_conv3x3.launches == fwd
    with pytest.raises(ValueError, match='dtype'):
        deform_conv.deform_conv3x3(x, off, weight.float(), bias, 4)
    x12, off12, w12, b12 = deform_inputs((1, 5, 6, 48), 4, gen)
    with pytest.raises(ValueError, match='multiples of 8'):
        deform_conv.deform_conv3x3(x12, off12, w12, b12, 4)



def test_affine_act_autograd_reaches_the_backward_kernel(gen):
    x = torch.randn(2, 64, 8, 16, generator=gen, device='cuda').to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    s = torch.randn(64, generator=gen, device='cuda', requires_grad=True)
    t = torch.randn(64, generator=gen, device='cuda', requires_grad=True)
    before = affine_act.affine_act_backward.launches
    affine_act.AffineAct.apply(x, s, t, None, True).float().sum().backward()
    assert affine_act.affine_act_backward.launches == before + 1
    assert x.grad is not None and s.grad is not None and t.grad is not None


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
    # a gradient request takes LiftSplat: the forward kernel, then K4' once
    dep = depth.detach().requires_grad_()
    before = voxel_pooling.lift_splat_factorized_backward.launches
    out = voxel_pooling.lift_splat_factorized(dep, ctx, idx, zvalid, g)
    assert voxel_pooling.lift_splat_factorized_backward.launches == before
    out.float().sum().backward()
    assert voxel_pooling.lift_splat_factorized_backward.launches == before + 1
    assert dep.grad.dtype == dtype and dep.grad.shape == depth.shape


def test_lift_splat_kernel_refusals(gen):
    """K4 raises for what it does not take: C not a multiple of 8, fH above
    64 (a gradient request is taken now: it runs K4', no plain fallback,
    and the gradients are the plain version's)."""
    from mm_training_tpu_torch.ops import voxel_pooling
    depth = torch.rand(1, 4, 8, 8, generator=gen, device='cuda')
    idx = torch.zeros(1, 4, 8, dtype=torch.int32, device='cuda')
    zvalid = torch.ones(1, 4, 8, 8, dtype=torch.bool, device='cuda')
    ctx16 = torch.rand(1, 8, 8, 16, device='cuda')
    dep = depth.clone().requires_grad_()
    before = voxel_pooling.lift_splat_factorized_backward.launches
    voxel_pooling.lift_splat_factorized(dep, ctx16, idx, zvalid, 10).sum().backward()
    assert voxel_pooling.lift_splat_factorized_backward.launches == before + 1
    want, _ = voxel_pooling.lift_splat_factorized_backward_plain(
        torch.ones(1, 10, 16, device='cuda'), depth, ctx16, idx, zvalid, 10)
    torch.testing.assert_close(dep.grad, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='multiple of 8'):
        voxel_pooling.lift_splat_factorized(depth.detach(), torch.rand(1, 8, 8, 12, device='cuda'),
                                            idx, zvalid, 10)
    tall = torch.rand(1, 4, 65, 8, device='cuda')
    with pytest.raises(ValueError, match='fH up to 64'):
        voxel_pooling.lift_splat_factorized(tall, torch.rand(1, 65, 8, 16, device='cuda'), idx,
                                            torch.ones_like(tall, dtype=torch.bool), 10)


@pytest.mark.parametrize('dtype,c', [(torch.bfloat16, 80), (torch.float32, 80),
                                     (torch.float32, 3), (torch.bfloat16, 3)])
def test_bev_warp_one_launch_forms_equal_plain(gen, dtype, c):
    """K7 at B=4 x 32 x 256: ``bda_bev_warp`` from a [B, 4, 4] and a
    [B, 3, 3] BDA matrix and ``warp_affine_nhwc`` at the identity and a
    projective matrix, each one launch, bit for bit with the plain versions
    (the closed-form inverse and the blend take the same rounded steps);
    the identity returns the map itself."""
    from mm_training_tpu_torch.data import random_bda_matrices
    from mm_training_tpu_torch.ops import warp
    img = torch.randn(4, 32, 256, c, generator=gen, device='cuda').to(dtype)
    bda = torch.as_tensor(random_bda_matrices(4, seed=2), device='cuda')
    for m in (bda, bda[:, :3, :3]):
        before = warp.bda_bev_warp.launches
        got = warp.bda_bev_warp(img, m)
        assert warp.bda_bev_warp.launches == before + 1
        assert torch.equal(got, warp.bda_bev_warp_plain(img, m))
    eye = torch.eye(3, device='cuda').expand(4, 3, 3)
    proj = warp.bda_pixel_matrix(bda, (32, 256))
    proj[:, 2, :2] = torch.rand(4, 2, generator=gen, device='cuda') * 4e-4 - 2e-4
    for m in (eye, proj):
        assert torch.equal(warp.warp_affine_nhwc(img, m), warp.warp_affine_nhwc_plain(img, m))
    assert torch.equal(warp.warp_affine_nhwc(img, eye), img)
    # a gradient request takes BevWarp: one forward launch, then K7' once
    src = img.detach().requires_grad_()
    before = (warp.bda_bev_warp.launches, warp.warp_backward.launches)
    warp.bda_bev_warp(src, bda).float().sum().backward()
    assert (warp.bda_bev_warp.launches, warp.warp_backward.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    assert src.grad.dtype == dtype


def test_camera_autograd_reaches_the_backward_kernels(gen):
    """The camera branch's three kernels under autograd on the card: a
    ``DeformConv2d`` with a gradient, the splat and the BEV warp each launch
    their backward kernel once a backward and match the same graph through
    the plain versions (float32, TF32 off)."""
    from unittest import mock
    from mm_training_tpu_torch.data import random_bda_matrices
    from mm_training_tpu_torch.models.depth_net import DeformConv2d
    from mm_training_tpu_torch.ops import deform_conv, voxel_pooling, warp
    torch.backends.cudnn.allow_tf32 = False
    m = DeformConv2d(32, 32, groups=4)
    m.reset_parameters(torch.Generator().manual_seed(2))
    with torch.no_grad():
        m.conv_offset.weight.normal_(0, 0.1)
    m = m.to('cuda').to(memory_format=torch.channels_last)
    x = torch.randn(2, 32, 6, 10, generator=gen, device='cuda').contiguous(
        memory_format=torch.channels_last)
    idx = torch.randint(0, 41, (2, 16, 10), generator=gen, device='cuda').int()
    zvalid = torch.rand(2, 16, 6, 10, generator=gen, device='cuda') < 0.7
    bda = torch.as_tensor(random_bda_matrices(1, seed=4), device='cuda')

    def run():
        xs = x.detach().requires_grad_()
        feat = m(xs)                                                # [2, 32, 6, 10]
        depth = feat[:, :16].softmax(1)
        ctx = feat[:, 16:].permute(0, 2, 3, 1)
        bev = voxel_pooling.lift_splat_factorized(depth, ctx, idx, zvalid, 40)
        out = warp.bda_bev_warp(bev.reshape(1, 2, 40, 16).sum(1, keepdim=True).reshape(
            1, 5, 8, 16), bda)
        grads = torch.autograd.grad((out * out).sum(), [xs, *m.parameters()])
        return grads
    counts = (voxel_pooling.lift_splat_factorized_backward, deform_conv.deform_conv3x3_backward,
              warp.warp_backward)
    before = [f.launches for f in counts]
    got = run()
    assert [f.launches for f in counts] == [b + 1 for b in before]
    with mock.patch.object(voxel_pooling, 'lift_splat_factorized',
                           voxel_pooling.lift_splat_factorized_plain), \
            mock.patch.object(deform_conv, 'deform_conv3x3', deform_conv.deform_conv3x3_plain), \
            mock.patch.object(warp, 'bda_bev_warp', warp.bda_bev_warp_plain):
        want = run()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())


def test_camera_train_step_runs_the_fused_dcn_backward(gen):
    """One tiny camera train step on the card: its DCN takes K5' (no columns
    kernel), its splat K4', and the loss is finite."""
    from mm_training_tpu_torch.configs import tiny_test_config
    from mm_training_tpu_torch.exps.profile_train import train_batch
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.ops import deform_conv, voxel_pooling
    from mm_training_tpu_torch.training import create_train_state, make_train_step
    cfg = tiny_test_config(use_cam=True)
    model = BEVDepthLiDAR(cfg, device='cuda', generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model)
    kernels = (deform_conv.deform_sample, deform_conv.deform_conv3x3_backward,
               voxel_pooling.lift_splat_factorized_backward)
    before = [k.launches for k in kernels]
    state, metrics = make_train_step(cfg)(state, train_batch(cfg, 0))
    torch.cuda.synchronize()
    after = [k.launches for k in kernels]
    assert after == [before[0], before[1] + 1, before[2] + 1], (before, after)
    assert torch.isfinite(metrics['train_loss'])



# ------------------------------------------------- K8, K8': the raw-rig splat

def _raw_chunks_combined(idx, n_cells, chunk):
    """The chunks of the (camera, cell) intervals longer than ``chunk``
    entries: K8 counts each one done with an integer atomic."""
    m = idx.shape[0]
    cell = idx.reshape(m, -1).long() + (n_cells + 1) * torch.arange(m, device=idx.device)[:, None]
    counts = torch.bincount(cell.reshape(-1), minlength=m * (n_cells + 1))
    counts = counts.reshape(m, n_cells + 1)[:, :n_cells]
    long_ = counts[counts > chunk]
    return int(((long_ + chunk - 1) // chunk).sum())


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('layout', ['channels_last', 'nchw'])
@pytest.mark.parametrize('batch_size', [1, 4])
def test_lift_splat_raw_kernel_on_the_pitched_rig(gen, dtype, layout, batch_size):
    """K8 on the pitched fake rig's own raw indices at the B=1 and B=4
    requests' shapes (4 and 16 cameras x 409 bins x 3520 pixels, C 80),
    depth and ctx as the path's views: one launch, within 1e-5 of each
    entry's sum of |terms| of the plain version (one bf16 ulp more in bf16).
    The counts it keeps on the card: each kept row scattered once with at
    most one integer atomic, one integer atomic per chunk of each interval
    longer than ``RAW_CHUNK``."""
    from mm_training_tpu_torch.configs import lidar_cam_radar
    from mm_training_tpu_torch.exps.backward_checks import raw_splat_errors
    from mm_training_tpu_torch.exps.kernel_inputs import raw_splat_inputs
    from mm_training_tpu_torch.ops import voxel_pooling
    depth, ctx, idx, n = raw_splat_inputs(lidar_cam_radar(batch_size=batch_size), gen,
                                          layout, dtype)
    assert not ctx.is_contiguous()
    before = voxel_pooling.lift_splat.launches
    errors = raw_splat_errors(depth, ctx, idx, n)
    assert voxel_pooling.lift_splat.launches == before + 1
    assert errors['ok'], errors
    counted = voxel_pooling.raw_splat_atomic_adds(depth, ctx, idx, n)
    kept = int((idx < n).sum())
    assert counted['kept_rows'] == kept, counted
    assert 0 < counted['scatter_int_atomics'] <= kept, counted
    assert 0 < counted['count_int_atomics'] <= kept, counted
    assert counted['combine_int_atomics'] == _raw_chunks_combined(idx, n,
                                                                  voxel_pooling.RAW_CHUNK)
    assert counted['combine_int_atomics'] > 0


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('m,d,p,c', [(2, 37, 13, 16), (1, 9, 40, 8), (3, 20, 7, 24),
                                     (1, 5, 33, 256), (2, 64, 700, 256)])
def test_lift_splat_raw_kernels_ragged(gen, dtype, m, d, p, c):
    """K8 and K8' at shapes that leave a warp's lanes idle (K8: C / 8 lanes
    an entry, 2, 1, 3, 32; K8': C / 8 warps a block, up to 32 at C = 256),
    pixel tiles cut short, with transposed (strided) depth and ctx, cells
    that repeat, change and hit the trash cell (at the last shape
    intervals of ~7,000 entries, cut into chunks); K8' also with an
    expanded gradient (stride 0 over the cameras) and a second call's same
    bits."""
    from mm_training_tpu_torch.exps.backward_checks import (raw_splat_backward_errors,
                                                             raw_splat_errors)
    n_cells = 11
    depth = torch.rand(m, p, d, generator=gen, device='cuda').to(dtype).transpose(1, 2)
    ctx = torch.randn(m, c, p, generator=gen, device='cuda').to(dtype).transpose(1, 2)
    idx = torch.randint(0, n_cells + 1, (m, d, p), generator=gen, device='cuda')
    idx = torch.where(torch.rand(m, d, p, generator=gen, device='cuda') < 0.5,
                      idx.roll(1, 1), idx).int()          # runs of a repeated cell
    errors = raw_splat_errors(depth, ctx, idx, n_cells)
    assert errors['ok'], errors
    g = torch.randn(1, n_cells, c, generator=gen, device='cuda').to(dtype).expand(m, -1, -1)
    errors = raw_splat_backward_errors(depth, ctx, idx, n_cells, g)
    assert errors['ok'], errors


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('layout', ['channels_last', 'nchw'])
@pytest.mark.parametrize('batch_size', [1, 4])
def test_lift_splat_raw_backward_kernel_matches_plain(gen, dtype, layout, batch_size):
    """K8' at the raw-rig train path's shapes (the pitched rig's indices):
    d depth and d ctx within 1e-5 of each entry's sum of |terms| of the
    plain version (one bf16 ulp more in bf16), the same bits on a second
    call, one launch a call."""
    from mm_training_tpu_torch.configs import lidar_cam_radar
    from mm_training_tpu_torch.exps.backward_checks import raw_splat_backward_errors
    from mm_training_tpu_torch.exps.kernel_inputs import raw_splat_inputs
    from mm_training_tpu_torch.ops import voxel_pooling
    depth, ctx, idx, n = raw_splat_inputs(lidar_cam_radar(batch_size=batch_size), gen,
                                          layout, dtype)
    g = torch.randn(idx.shape[0], n, ctx.shape[-1], generator=gen, device='cuda').to(dtype)
    before = voxel_pooling.lift_splat_backward.launches
    errors = raw_splat_backward_errors(depth, ctx, idx, n, g)
    assert voxel_pooling.lift_splat_backward.launches == before + 2
    assert errors['ok'], errors


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_lift_splat_raw_kernels_one_cell_and_all_trash(gen, dtype):
    """K8 and K8' at the raw-rig camera's size (409 bins x 3520 pixels, C
    80): every row of camera 0 in one cell (the longest interval a camera
    can give, 1,439,680 entries in 5,624 chunks), every row of camera 1
    trash (zeros out, zero d depth), camera 2 the pitched rig's cells."""
    from mm_training_tpu_torch.configs import lidar_cam_radar
    from mm_training_tpu_torch.exps.backward_checks import (raw_splat_backward_errors,
                                                             raw_splat_errors)
    from mm_training_tpu_torch.exps.kernel_inputs import raw_splat_inputs
    from mm_training_tpu_torch.ops import voxel_pooling
    depth, ctx, idx, n = raw_splat_inputs(lidar_cam_radar(batch_size=1), gen, 'nchw', dtype)
    depth, ctx, idx = depth[:3], ctx[:3], idx[:3].clone()
    idx[0] = 4321
    idx[1] = n
    errors = raw_splat_errors(depth, ctx, idx, n)
    assert errors['ok'], errors
    out = voxel_pooling.lift_splat(depth, ctx, idx, n)
    assert not out[1].any() and out[0, 4321].abs().sum() > 0
    assert not out[0, :4321].any() and not out[0, 4322:].any()
    g = torch.randn(3, n, ctx.shape[-1], generator=gen, device='cuda').to(dtype)
    errors = raw_splat_backward_errors(depth, ctx, idx, n, g)
    assert errors['ok'], errors
    d_depth, _ = voxel_pooling.lift_splat_backward(g, depth, ctx, idx, n)
    assert not d_depth[1].any()


def test_lift_splat_raw_kernel_beyond_the_shared_histogram(gen):
    """K8 with more cells than its shared histogram holds (20,000): the
    counts go to device memory by integer atomics, one a distinct cell of
    a warp-bin; against the plain version."""
    from mm_training_tpu_torch.exps.backward_checks import raw_splat_errors
    from mm_training_tpu_torch.ops import voxel_pooling
    n_cells = 20_000
    depth = torch.rand(2, 30, 300, generator=gen, device='cuda').bfloat16()
    ctx = torch.randn(2, 300, 16, generator=gen, device='cuda').bfloat16()
    idx = torch.randint(0, n_cells + 1, (2, 30, 300), generator=gen, device='cuda')
    idx[:, :, :100] = torch.randint(0, 3, (2, 30, 100), generator=gen, device='cuda')
    idx = idx.int()
    errors = raw_splat_errors(depth, ctx, idx, n_cells)
    assert errors['ok'], errors
    counted = voxel_pooling.raw_splat_atomic_adds(depth, ctx, idx, n_cells)
    assert counted['kept_rows'] == int((idx < n_cells).sum())


def test_lift_splat_raw_kernels_have_no_float_atomic_in_their_sass(gen):
    """The built K8 and K8' hold no float atomic or reduction instruction
    in their SASS (``cuobjdump -sass``), in either dtype's kernel; K4,
    whose 16-byte float atomics the same scan must find, shows that it
    reads them."""
    from mm_training_tpu_torch.ops import build
    for kernel in ('lift_splat_raw_kernel', 'lift_splat_raw_bwd_kernel'):
        found = build.float_atomics('lift_splat_raw', kernel)
        assert not any(found.values()), (kernel, found)
    k4 = build.float_atomics('lift_splat', 'lift_splat_kernel')
    assert any(k4.values()), k4


def test_lift_splat_raw_refusals_and_autograd(gen):
    """K8 raises for C not a multiple of 8 or above ``RAW_MAX_C``; with a
    gradient it runs through ``LiftSplatRaw`` (K8, then K8'), whose
    gradients are the plain version's."""
    from mm_training_tpu_torch.ops import voxel_pooling
    depth = torch.rand(2, 6, 10, generator=gen, device='cuda')
    ctx = torch.randn(2, 10, 16, generator=gen, device='cuda')
    idx = torch.randint(0, 8, (2, 6, 10), generator=gen, device='cuda').int()
    dep, cx = depth.clone().requires_grad_(), ctx.clone().requires_grad_()
    before = (voxel_pooling.lift_splat.launches, voxel_pooling.lift_splat_backward.launches)
    g = torch.randn(2, 7, 16, generator=gen, device='cuda')
    voxel_pooling.lift_splat(dep, cx, idx, 7).backward(g)
    assert (voxel_pooling.lift_splat.launches,
            voxel_pooling.lift_splat_backward.launches) == (before[0] + 1, before[1] + 1)
    want = voxel_pooling.lift_splat_backward_plain(g, depth, ctx, idx, 7)
    torch.testing.assert_close(dep.grad, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cx.grad, want[1], rtol=1e-5, atol=1e-5)
    for c in (12, voxel_pooling.RAW_MAX_C + 8):
        with pytest.raises(ValueError, match='multiple of 8'):
            voxel_pooling.lift_splat(depth, torch.randn(2, 10, c, device='cuda'), idx, 7)
    with pytest.raises(ValueError, match='int32'):
        voxel_pooling.lift_splat(depth, ctx, idx.long(), 7)


def test_raw_rig_camera_train_step_runs_k8(gen):
    """One tiny raw-rig camera train step on the card (the rig pitched by 3
    degrees, the oracle off): its splat takes K8 forward and K8' backward,
    never K4 or K4', and the loss is finite."""
    from mm_training_tpu_torch.configs import raw_rig, tiny_test_config
    from mm_training_tpu_torch.exps.profile_train import train_batch
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.ops import voxel_pooling
    from mm_training_tpu_torch.training import create_train_state, make_train_step
    cfg = raw_rig(tiny_test_config(use_cam=True, use_depth_loss=False))
    model = BEVDepthLiDAR(cfg, device='cuda', generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model)
    kernels = (voxel_pooling.lift_splat, voxel_pooling.lift_splat_backward,
               voxel_pooling.lift_splat_factorized, voxel_pooling.lift_splat_factorized_backward)
    before = [k.launches for k in kernels]
    state, metrics = make_train_step(cfg)(state, train_batch(cfg, 0, pitch_deg=3.0))
    torch.cuda.synchronize()
    after = [k.launches for k in kernels]
    assert after == [before[0] + 1, before[1] + 1, before[2], before[3]], (before, after)
    assert torch.isfinite(metrics['train_loss'])


# ------------------------------ the sparse-import path: K1's sparse mode, masked A / A'

def _sparse_points(gen, kind, batch_size):
    from mm_training_tpu_torch.configs import lidar_radar
    from mm_training_tpu_torch.exps.kernel_inputs import lidar_like_points
    if kind == 'uniform':
        return _k1_points(gen, batch_size)
    cfg = lidar_radar()
    pts, mask = lidar_like_points(cfg, batch_size, seed=batch_size,
                                  crowd=20_000 if kind == 'crowded' else 0)
    return pts, mask, (cfg.point_cloud_range, cfg.voxel_size, cfg.out_shape)


@pytest.mark.parametrize('kind', ['lidar_like', 'uniform', 'crowded'])
@pytest.mark.parametrize('batch_size', [1, 4])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('cap', [15, 1, 1000, 5000])
def test_sparse_encoder_input_kernel_matches_plain(gen, kind, batch_size, dtype, cap):
    """K1's sparse-input mode at B=1 and B=4 (100k points a frame on the
    full 256 x 2048 grid; LiDAR-like frames with pillars of up to ~450
    points, the same with 20,000 points in one pillar of every frame, and
    uniform ones with few points a pillar), at caps that take the warp
    selection (15, 1; a block's warps for the crowded pillar), the block's
    sort (1000: every pillar of more than four points) and its radix select
    and walk in input order (1000 and 5000 on the crowded pillar): the kept
    set of the first-K cap
    and the occupancy bit for bit, the means within one bf16 ulp plus K1's
    slack (the plain version's atomics add in no fixed order), the pad zero,
    one launch a call, and every output the same bits on a second call."""
    pts, mask, geo = _sparse_points(gen, kind, batch_size)
    args = (pts, mask, *geo, 5, dtype, 16)   # the sparse encoder's 16 channels
    kw = dict(max_points_per_voxel=cap, return_kept=True)
    before = voxelize.sparse_encoder_input.launches
    grid, occ, kept = voxelize.sparse_encoder_input(*args, **kw)
    assert voxelize.sparse_encoder_input.launches == before + 1
    w_grid, w_occ, w_kept = voxelize.sparse_encoder_input_plain(*args, **kw)
    assert grid.shape == (batch_size, 256, 2048, 16) and grid.dtype == dtype
    assert occ.shape == (batch_size, 1, 256, 2048) and occ.dtype == torch.bool
    assert torch.equal(kept, w_kept) and torch.equal(occ, w_occ)
    g = 256 * 2048
    seg = voxelize.pillar_segments(pts, mask, *geo)
    frames = seg + torch.arange(batch_size, device='cuda')[:, None] * (g + 1)
    counts = torch.bincount(frames.flatten(), minlength=batch_size * (g + 1))
    fullest = int(counts.view(batch_size, g + 1)[:, :g].max())
    assert (int(kept.sum()) < int((seg < g).sum())) == (fullest > cap)   # the cap acted
    assert _k1_outside_tolerance(grid, w_grid) == 0
    assert not grid[..., 5:].any() and grid[..., :5].abs().sum() > 0
    grid2, occ2, kept2 = voxelize.sparse_encoder_input(*args, **kw)
    assert torch.equal(grid2, grid) and torch.equal(kept2, kept) and torch.equal(occ2, occ)


@pytest.mark.parametrize('cap', [15, 5000])
def test_sparse_encoder_input_2_24_points_in_one_pillar(gen, cap):
    """A frame of 2^24 points, all masked in and all in one pillar (the
    selection's worst case; no longer refused now that the counts are
    integers): the kept set is exactly the first K indices, the mean theirs,
    one launch."""
    n = 2 ** 24
    pts = torch.zeros(1, n, 5, device='cuda')
    i = torch.arange(n, device='cuda')
    # features whose sums are exact in fp32 in any order: the mean is one rounding
    pts[0, :, 3] = (i % 97).float()
    pts[0, :, 4] = (i * 37 % 1024).float() / 1024
    mask = torch.ones(1, n, dtype=torch.bool, device='cuda')
    geo = ((-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), (0.5, 0.5, 2.0), (4, 4))
    before = voxelize.sparse_encoder_input.launches
    grid, occ, kept = voxelize.sparse_encoder_input(pts, mask, *geo, 5, torch.float32, 8,
                                                    max_points_per_voxel=cap,
                                                    return_kept=True)
    assert voxelize.sparse_encoder_input.launches == before + 1
    assert kept[0, :cap].all() and not kept[0, cap:].any()
    assert occ.sum() == 1 and occ[0, 0, 2, 2]
    want = pts[0, :cap].double().mean(0).float()
    torch.testing.assert_close(grid[0, 2, 2, :5], want, rtol=1e-5, atol=1e-6)
    assert not grid[0, 2, 2, 5:].any() and int((grid != 0).any(-1).sum()) == 1


def test_sparse_encoder_input_empty_out_of_range_and_one_device_op(gen):
    """No masked-in point, and every point outside the grid: zeros, no
    occupied pillar, nothing kept; calls at other batch sizes in turn see
    their own points only (the counts the kernel leaves zero), at rows that
    are and are not a multiple of 16 bytes; one device op a call."""
    from mm_training_tpu_torch.exps.timing import device_ops_in_child
    pts, mask, geo = _sparse_points(gen, 'lidar_like', 2)
    far = pts.clone()
    far[..., 0] += 1000.0
    for p, m in ((pts, torch.zeros_like(mask)), (far, mask)):
        grid, occ, kept = voxelize.sparse_encoder_input(p, m, *geo, 5, torch.bfloat16, 8,
                                                        max_points_per_voxel=15,
                                                        return_kept=True)
        assert not grid.any() and not occ.any() and not kept.any()
    for dtype, channels in ((torch.float32, 8), (torch.bfloat16, 5), (torch.float32, 6)):
        for p, m in ((pts, mask), (pts[:1], mask[:1]), (pts, mask)):
            kw = dict(max_points_per_voxel=15, return_kept=True)
            got = voxelize.sparse_encoder_input(p, m, *geo, 5, dtype, channels, **kw)
            want = voxelize.sparse_encoder_input_plain(p, m, *geo, 5, dtype, channels, **kw)
            assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
            assert _k1_outside_tolerance(got[0], want[0]) == 0
    ops, = device_ops_in_child([[('ops.voxelize', 'sparse_encoder_input', (pts, mask, *geo),
                                  dict(dtype=torch.bfloat16, channels=8,
                                       max_points_per_voxel=15))]])
    assert list(ops.values()) == [1] and 'sparse' in next(iter(ops)), ops


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape', [(4, 16, 256, 2048), (1, 128, 32, 256), (2, 7, 3, 5),
                                   (2, 3, 5, 7)])
def test_affine_act_masked_kernels_match_plain(gen, dtype, shape):
    """Kernel A's masked form and A''s at the sparse encoder's largest tail
    ([4, 16, 256, 2048]), its last stage, and channel counts below a
    16-byte vector: the forward, dx and d residual bit for bit, d scale and
    d shift to fp32 order and the same bits on a second call; each form
    counts its own launches, the unmasked counts stay."""
    x, r, g, s, t = _backward_case(gen, shape, dtype)
    n, _, h, w = shape
    mask = (torch.rand(n, 1, h, w, generator=gen, device='cuda') < 0.3).contiguous()
    counts = (affine_act.affine_act.launches, affine_act.affine_act_backward.launches)
    for res in (None, (r * mask.to(dtype)).contiguous(memory_format=torch.channels_last), r):
        before = affine_act.affine_act_masked.launches
        got = affine_act.affine_act_masked(x, s, t, mask, res)
        assert affine_act.affine_act_masked.launches == before + 1
        assert torch.equal(got, affine_act.affine_act_masked_plain(x, s, t, mask, res))
        before = affine_act.affine_act_masked_backward.launches
        grads = affine_act.affine_act_masked_backward(g, x, s, t, mask, res)
        assert affine_act.affine_act_masked_backward.launches == before + 1
        want = affine_act.affine_act_masked_backward_plain(g, x, s, t, mask, res)
        assert torch.equal(grads[0], want[0])
        if res is not None:
            assert torch.equal(grads[1], want[1])
        for a, b in zip(grads[2:], want[2:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * n * h * w)
        again = affine_act.affine_act_masked_backward(g, x, s, t, mask, res)
        assert all(torch.equal(a, b) for a, b in zip(grads, again) if a is not None)
    assert counts == (affine_act.affine_act.launches, affine_act.affine_act_backward.launches)


def test_masked_kernels_are_one_device_op_a_call(gen):
    from mm_training_tpu_torch.exps.timing import device_ops_in_child
    x, r, g, s, t = _backward_case(gen, (4, 16, 256, 2048), torch.bfloat16)
    mask = (torch.rand(4, 1, 256, 2048, generator=gen, device='cuda') < 0.3).contiguous()
    fwd, bwd = device_ops_in_child([
        [('ops.affine_act', 'affine_act_masked', (x, s, t, mask, r), {})],
        [('ops.affine_act', 'affine_act_masked_backward', (g, x, s, t, mask, r), {})]])
    assert list(fwd.values()) == [1] and list(bwd.values()) == [1], (fwd, bwd)


def test_sparse_import_model_runs_the_masked_kernels(gen):
    """The tiny ``sparse_import`` model on the card: a request launches K1's
    sparse mode once and masked A at each of the encoder's 21 tails, a train
    step masked A' at each; float32 pred maps within 1e-4 of the CPU
    model's (TF32 off)."""
    import dataclasses

    from mm_training_tpu_torch.configs import tiny_test_config
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.training import create_train_state, make_train_step
    cfg = tiny_test_config()
    cfg = cfg.replace(lidar_conf=dataclasses.replace(cfg.get_lidar_conf(),
                                                     variant='sparse_import'))
    batch = make_fake_batch(cfg, seed=0)
    cpu = BEVDepthLiDAR(cfg, device='cpu')
    card = BEVDepthLiDAR(cfg, device='cuda')
    card.load_state_dict(cpu.state_dict())
    pts, mask = (torch.as_tensor(batch[k]) for k in ('points', 'point_mask'))
    counts = (voxelize.sparse_encoder_input.launches, affine_act.affine_act_masked.launches)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = card(pts.cuda(), mask.cuda())
            want = cpu(pts, mask)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert (voxelize.sparse_encoder_input.launches - counts[0],
            affine_act.affine_act_masked.launches - counts[1]) == (1, 21)
    for gp, wp in zip(got, want):
        for k in wp:
            torch.testing.assert_close(gp[k].cpu(), wp[k], rtol=1e-4, atol=1e-4)
    state = create_train_state(cfg, card, steps_per_epoch=10)
    before = affine_act.affine_act_masked_backward.launches
    make_train_step(cfg)(state, batch)
    assert affine_act.affine_act_masked_backward.launches - before == 21


def test_halo_pad_and_sharded_affine_act_match_unsharded(gen):
    """Two gloo ranks on the card at ``model_parallel=2`` (the halo and the
    BN moments through pinned host buffers): a train-mode 3x3 ConvBN on W
    shards (kernel A on the whole map's statistics, A' its backward) equals
    the unsharded one on the card in float32 (TF32 off; the conv's sums in
    another order: 1e-4), each rank launching A and A' once."""
    import importlib
    import os

    from mm_training_tpu_torch.parallel import dryrun
    # by path: another installed package may be named ``tests``
    here = os.path.dirname(os.path.abspath(__file__))
    ranks = dryrun.spawn_ranks(2, 'torch_mp_worker:cuda_shard_case', model_parallel=2,
                               device='cuda:0', backend='gloo', env={'PYTHONPATH': os.pathsep.join(
                                   [here, os.path.dirname(here)])})
    want = importlib.import_module('torch_mp_worker').cuda_shard_case()
    assert want['launches'] == (1, 1)
    for key in ('y', 'dx'):
        got = np.concatenate([r[key] for r in ranks], axis=-1)
        np.testing.assert_allclose(got, want[key], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[key]).max(), err_msg=key)
    for name, w in want['dparams'].items():
        np.testing.assert_allclose(sum(r['dparams'][name] for r in ranks), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    assert [r['launches'] for r in ranks] == [(1, 1), (1, 1)]
