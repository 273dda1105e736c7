"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
false. No JAX here, so the file runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from mm_training_tpu_torch.ops import affine_act, circle_nms, voxelize

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
