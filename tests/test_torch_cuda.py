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
