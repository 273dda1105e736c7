"""The bound the DCN backward K5' is held to on the card
(``exps/backward_checks.py::deform_cols_reference``), on the CPU in
float64, and the backward wrappers' refusals of shapes they do not take.

K5' computes the columns' gradient d cols = dY W^T itself and rounds each
entry once to x's dtype. In bf16 that entry is at most half an ulp from its
float32 sum, and an entry near a rounding midpoint may land on either side
of it: one ulp between the two roundings. The bound takes one such rounding
of every entry, carried through the transposed sampling, and no more: d
cols moved by half an ulp an entry stays inside it, moved by two ulps it
leaves it.
"""
import numpy as np
import pytest
import torch

from mm_training_tpu_torch.exps import backward_checks
from mm_training_tpu_torch.ops import deform_conv, voxel_pooling


def _one_pixel_case(seed):
    """(x, offsets, weight, dy) in float64, 2 groups of 8 channels: zero
    offsets (every tap on a whole pixel, weight 1), a weight of signed
    powers of two and dy one at one pixel and one channel of each group, so
    each d cols entry is a single term, a power of two, and reaches one
    pixel of d x; x is +1 on even rows and -1 on odd ones, so the offsets'
    one-sided differences along y are +-2 on every channel."""
    rng = np.random.default_rng(seed)
    b, h, w, c, g, og = 1, 5, 6, 16, 2, 8
    rows = torch.tensor([1.0, -1.0], dtype=torch.float64)[torch.arange(h) % 2]
    x = rows[None, :, None, None].expand(b, h, w, c).contiguous()
    off = torch.zeros(b, h, w, 18)
    signs = rng.choice([-1.0, 1.0], size=(g, 9 * c // g, og))
    wgt = torch.from_numpy(signs * 2.0 ** rng.integers(-3, 4, size=signs.shape))
    dy = torch.zeros(b, h, w, g * og, dtype=torch.float64)
    dy[0, 2, 3, 0] = dy[0, 2, 3, og] = 1.0
    return x, off, wgt, dy


def _bf16_ulp(v):
    """One bf16 ulp (8 significant bits) at each entry of v."""
    a = v.abs()
    return torch.where(a == 0, 0.0, torch.exp2(torch.floor(torch.log2(a)) - 7))


@pytest.mark.parametrize('ulps,covered', [(0.5, True), (2.0, False)])
def test_deform_bound_takes_one_rounding_of_d_cols(ulps, covered):
    """d x and d offsets of d cols moved by ``ulps`` bf16 ulps an entry,
    against the bf16 bound of the exact d cols: half an ulp (a rounding
    that flipped at a midpoint) is inside, two ulps are outside, for d x and
    for d offsets alike."""
    x, off, wgt, dy = _one_pixel_case(0)
    b, h, w, _ = x.shape
    g, _, og = wgt.shape
    (ref_dx, mag_x, flip_x), (ref_doff, mag_off, flip_off) = \
        backward_checks.deform_cols_reference(dy, x, off, wgt, g, torch.bfloat16)
    dcols = torch.bmm(dy.reshape(b * h * w, g, og).transpose(0, 1), wgt.transpose(1, 2))
    assert torch.count_nonzero(dcols) == 2 * wgt.shape[1]
    got_dx, got_doff = deform_conv.deform_sample_backward_plain(
        dcols + ulps * _bf16_ulp(dcols), x, off, g)
    out_x = backward_checks.outside(got_dx.float(), ref_dx, mag_x, flip_x)
    out_off = backward_checks.outside(got_doff, ref_doff, mag_off, flip_off)
    if covered:
        assert out_x['outside'] == 0 and out_off['outside'] == 0, (out_x, out_off)
    else:
        assert out_x['outside'] > 0 and out_off['outside'] > 0, (out_x, out_off)


def test_deform_bound_without_the_rounding_term_refuses_a_flip():
    """The d cols term is what lets a flipped rounding through: without it
    the same half-ulp move leaves the bound."""
    x, off, wgt, dy = _one_pixel_case(1)
    b, h, w, _ = x.shape
    g, _, og = wgt.shape
    (ref_dx, mag_x, _), (ref_doff, mag_off, _) = \
        backward_checks.deform_cols_reference(dy, x, off, wgt, g, torch.bfloat16)
    dcols = torch.bmm(dy.reshape(b * h * w, g, og).transpose(0, 1), wgt.transpose(1, 2))
    _, got_doff = deform_conv.deform_sample_backward_plain(dcols + 0.5 * _bf16_ulp(dcols), x,
                                                           off, g)
    assert backward_checks.outside(got_doff, ref_doff, mag_off)['outside'] > 0


def test_backward_wrappers_refuse_shapes_they_do_not_take():
    """On any device: the DCN backward refuses a dy of another shape than
    its output's and a weight that does not fit the groups; the splat's
    backward a g of another shape than its output's."""
    x, off, wgt, dy = (t.float() for t in _one_pixel_case(2))
    bias = torch.zeros(16)
    with pytest.raises(ValueError, match='dy'):
        deform_conv.deform_conv3x3_backward(dy[..., :8], x, off, wgt, bias, 2)
    with pytest.raises(ValueError, match='groups'):
        deform_conv.deform_conv3x3_backward(dy, x, off, wgt[:, :70], bias, 2)
    d_x, d_off, d_w, d_b = deform_conv.deform_conv3x3_backward(dy, x, off, wgt, bias, 2)
    assert d_x.shape == x.shape and d_off.shape == off.shape and d_w.shape == wgt.shape
    depth = torch.rand(1, 5, 3, 4)
    ctx = torch.rand(1, 3, 4, 8)
    idx = torch.zeros(1, 5, 4, dtype=torch.int32)
    zvalid = torch.ones(1, 5, 3, 4, dtype=torch.bool)
    with pytest.raises(ValueError, match='g '):
        voxel_pooling.lift_splat_factorized_backward(torch.zeros(1, 7, 8), depth, ctx, idx,
                                                     zvalid, 6)
