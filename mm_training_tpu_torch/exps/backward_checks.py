"""The backward kernels K4', K5', K7' and K8' (and K8 itself) against their
plain versions on the card, with the tolerance each is held to. Shared by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Each check runs the kernel's wrapper on CUDA tensors, runs the plain version
(autograd through the plain forward) on the same inputs raised to float32,
and bounds the difference entry by entry: the kernels sum in float32, in
another order than the plain version (K4' in a fixed order, K5''s d x and
K7' by float32 atomics in no fixed order), so a float32 result may differ
by 1e-5 of the entry's sum of |terms| (computed in float64 from the same
linear backward on magnitudes), and a bf16 result, rounded once, by one
bf16 ulp of the float32 reference plus that. K7' sums in a fixed order:
the same bits on a second call.

K8 and K8' round each product to the inputs' dtype, as the JAX package's
bf16 slab (and autograd through the plain version) does, and sum in
float32: they are held to the plain version run in the same dtype, with the
same bound (the plain version's float32 sums in another order, then one
rounding), and K8' also to the same bits on a second call.

K5' computes the columns' gradient d cols = dY W^T itself, a tile at a time
on the tensor cores, and rounds each entry once to x's dtype before the
transposed sampling, as JAX's einsum transpose gives it in that dtype. Its
float32 sum runs in another order than the reference's, and in bf16 an
entry near a rounding midpoint can round the other way. So d x and d
offsets are held to the plain transposed sampling of the float32 d cols
(dY raised to float32, times W^T), and their bound gains one rounding of
each d cols entry: 2^-8 (bf16's unit roundoff; 0 in float32) plus 1e-5 (the
order of its float32 sum) of that entry's sum of |terms|, sum |dY| |W|,
carried through the same linear map in float64 (:func:`deform_cols_reference`).
For a bf16 x, d x also takes the corner weights rounded to bf16 (the
forward's, and the JAX package's ``cwm.astype``) where the float32
reference keeps them: 2^-8 of its sum of |terms| more. d weight and d bias
are held to autograd through the plain forward in float64, within a
rounding of the tensor's largest entry (2^-7 in bf16, 1e-5 in float32):
each of their sums runs over every pixel of the batch (56,320 at the B=4
camera train step), where a float32 reference's own rounding, in cuBLAS's
order, is of the size of that bound. d offsets, d weight and d bias are
summed in a fixed order: the same bits on a second call.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops import deform_conv, voxel_pooling, warp

__all__ = ['deform_backward_errors', 'deform_cols_reference', 'outside',
           'raw_splat_backward_errors', 'raw_splat_errors', 'splat_backward_errors',
           'warp_backward_errors']

ORDER = 1e-5                    # float32 sums in another order: of the sum of |terms|
ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float32: 0.0}   # one rounding to the dtype


def _ulp(ref: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One ulp of ``dtype`` at each entry of the float32 ``ref`` (bf16: 8
    bits of mantissa; float32: none, the bound alone holds)."""
    if dtype != torch.bfloat16:
        return torch.zeros_like(ref)
    a = ref.abs()
    return torch.where(a == 0, 0.0, torch.exp2(torch.floor(torch.log2(a)) - 7))


def outside(got: torch.Tensor, ref: torch.Tensor, magnitude: torch.Tensor,
            extra: torch.Tensor = None) -> Dict:
    """Entries of ``got`` beyond one ulp of its dtype plus 1e-5 of the sum
    of |terms| (and a float32 rounding of the entry, and ``extra`` where
    given) from the float32 ``ref``; the largest |difference|."""
    diff = (got.float() - ref.float()).abs()
    bound = _ulp(ref.float(), got.dtype) + ORDER * magnitude.float() + 1.2e-7 * ref.float().abs()
    if extra is not None:
        bound = bound + extra.float()
    return {'outside': int((diff > bound).sum()), 'max_abs_err': diff.max().item()}


def splat_backward_errors(depth, ctx, idx, zvalid, n_cells, g) -> Dict:
    """K4' (:func:`~mm_training_tpu_torch.ops.voxel_pooling.
    lift_splat_factorized_backward`) against its plain version: d depth and
    d ctx, each within the module's bound; the same bits on a second call
    (every output is written once, in a fixed order)."""
    got_d, got_c = voxel_pooling.lift_splat_factorized_backward(g, depth, ctx, idx, zvalid,
                                                                n_cells)
    again = voxel_pooling.lift_splat_factorized_backward(g, depth, ctx, idx, zvalid, n_cells)
    ref_d, ref_c = voxel_pooling.lift_splat_factorized_backward_plain(
        g.float(), depth.float(), ctx.float(), idx, zvalid, n_cells)
    mag_d, _ = voxel_pooling.lift_splat_factorized_backward_plain(
        g.double().abs(), depth.double(), ctx.double().abs(), idx, zvalid, n_cells)
    _, mag_c = voxel_pooling.lift_splat_factorized_backward_plain(
        g.double().abs(), depth.double().abs(), ctx.double(), idx, zvalid, n_cells)
    out = {'d_depth': outside(got_d, ref_d, mag_d), 'd_ctx': outside(got_c, ref_c, mag_c),
           'deterministic': torch.equal(again[0], got_d) and torch.equal(again[1], got_c),
           'dtypes': [str(got_d.dtype), str(got_c.dtype)]}
    out['max_abs_err'] = max(out['d_depth']['max_abs_err'], out['d_ctx']['max_abs_err'])
    out['ok'] = (out['d_depth']['outside'] == 0 and out['d_ctx']['outside'] == 0
                 and out['deterministic'] and got_d.dtype == depth.dtype
                 and got_c.dtype == ctx.dtype)
    return out


def warp_backward_errors(img, mat, bda_n, g) -> Dict:
    """K7' (:func:`~mm_training_tpu_torch.ops.warp.warp_backward`) against
    its plain version: d img within the module's bound; the same bits on a
    second call."""
    got = warp.warp_backward(g, img, mat, bda_n)
    again = warp.warp_backward(g, img, mat, bda_n)
    ref = warp.warp_backward_plain(g.float(), img.float(), mat, bda_n)
    mag = warp.warp_backward_plain(g.double().abs(), img.double(), mat, bda_n)
    out = outside(got, ref, mag)
    out['deterministic'] = torch.equal(again, got)
    out['ok'] = out['outside'] == 0 and out['deterministic'] and got.dtype == img.dtype
    return out


def raw_splat_errors(depth, ctx, idx, n_cells) -> Dict:
    """K8 (:func:`~mm_training_tpu_torch.ops.voxel_pooling.lift_splat`)
    against its plain version in the same dtype, within the module's bound
    (a cell's entries come in the order its scatter's atomics give them)."""
    got = voxel_pooling.lift_splat(depth, ctx, idx, n_cells)
    ref = voxel_pooling.lift_splat_plain(depth, ctx, idx, n_cells)
    mag = voxel_pooling.lift_splat_plain(depth.double().abs(), ctx.double().abs(), idx, n_cells)
    out = outside(got, ref, mag)
    out['ok'] = out['outside'] == 0 and got.dtype == ctx.dtype
    return out


def raw_splat_backward_errors(depth, ctx, idx, n_cells, g) -> Dict:
    """K8' (:func:`~mm_training_tpu_torch.ops.voxel_pooling.
    lift_splat_backward`) against its plain version in the same dtype: d
    depth and d ctx, each within the module's bound; the same bits on a
    second call (every output is written once, in a fixed order)."""
    got_d, got_c = voxel_pooling.lift_splat_backward(g, depth, ctx, idx, n_cells)
    again = voxel_pooling.lift_splat_backward(g, depth, ctx, idx, n_cells)
    ref_d, ref_c = voxel_pooling.lift_splat_backward_plain(g, depth, ctx, idx, n_cells)
    mag_d, _ = voxel_pooling.lift_splat_backward_plain(
        g.double().abs(), depth.double(), ctx.double().abs(), idx, n_cells)
    _, mag_c = voxel_pooling.lift_splat_backward_plain(
        g.double().abs(), depth.double().abs(), ctx.double(), idx, n_cells)
    out = {'d_depth': outside(got_d, ref_d, mag_d), 'd_ctx': outside(got_c, ref_c, mag_c),
           'deterministic': torch.equal(again[0], got_d) and torch.equal(again[1], got_c)}
    out['max_abs_err'] = max(out['d_depth']['max_abs_err'], out['d_ctx']['max_abs_err'])
    out['ok'] = (out['d_depth']['outside'] == 0 and out['d_ctx']['outside'] == 0
                 and out['deterministic'] and got_d.dtype == depth.dtype
                 and got_c.dtype == ctx.dtype)
    return out


def _offset_magnitude(x, offsets, dcols, groups):
    """Per (pixel, tap) and coordinate, float64: the sum over the tap's
    corners inside the image of sum_c |dcols_c| |x[corner, c]|, which bounds
    the terms of d offsets (each corner weight's derivative is at most 1)."""
    b, h, w, c = x.shape
    g = groups
    d = dcols.double().abs().reshape(g, b * h * w, 9, c // g).permute(1, 2, 0, 3)
    d = d.reshape(b, h * w * 9, c)
    off = offsets.float().reshape(b, h, w, 9, 2)
    dev = x.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    k = torch.arange(3, dtype=torch.float32, device=dev) - 1
    base_dy, base_dx = torch.meshgrid(k, k, indexing='ij')
    y0 = torch.floor((ys[None, :, :, None] + base_dy.reshape(-1)) + off[..., 0]).long()
    x0 = torch.floor((xs[None, :, :, None] + base_dx.reshape(-1)) + off[..., 1]).long()
    xa = x.double().abs().reshape(b, h * w, c)
    batch = torch.arange(b, device=dev)[:, None]
    mag = torch.zeros(b, h * w * 9, dtype=torch.float64, device=dev)
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi, xi = (y0 + dy).reshape(b, -1), (x0 + dx).reshape(b, -1)
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        rows = xa[batch, yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        mag += torch.where(inb, (rows * d).sum(-1), 0.0)
    return mag.reshape(b, h, w, 9, 1).expand(b, h, w, 9, 2).reshape(b, h, w, 18)


def deform_cols_reference(dy, x, offsets, weight, groups: int, dtype: torch.dtype):
    """The plain transposed sampling of d cols = dY W^T computed in float32
    (float64 for float64 inputs), and what bounds a kernel that works in
    ``dtype`` against it: ((d x, its sum of |terms|, its d cols rounding
    term), (d offsets, the same)), the magnitudes in float64. The rounding
    term is (2^-8 in bf16 + 1e-5) of each d cols entry's sum of |terms|,
    sum |dY| |W|, carried through the transposed sampling; for bf16 the d x
    magnitude also carries the corner weights' bf16 rounding."""
    b, h, w, c = x.shape
    og = weight.shape[2]
    ct = torch.promote_types(x.dtype, torch.float32)

    def cols(d, wt):
        return torch.bmm(d.reshape(b * h * w, groups, og).transpose(0, 1), wt.transpose(1, 2))
    dcols = cols(dy.to(ct), weight.to(ct))
    mag_cols = cols(dy.double().abs(), weight.double().abs())
    ref_dx, ref_doff = deform_conv.deform_sample_backward_plain(dcols, x.to(ct), offsets, groups)
    mag_x, _ = deform_conv.deform_sample_backward_plain(dcols.double().abs(), x.double(),
                                                        offsets, groups)
    if dtype == torch.bfloat16:
        mag_x = mag_x * (1.0 + ROUNDOFF[dtype] / ORDER)
    rounding = ROUNDOFF[dtype] + ORDER
    flip_x, _ = deform_conv.deform_sample_backward_plain(mag_cols, x.double(), offsets, groups)
    return ((ref_dx, mag_x, rounding * flip_x),
            (ref_doff, _offset_magnitude(x, offsets, dcols, groups),
             rounding * _offset_magnitude(x, offsets, mag_cols, groups)))


def deform_backward_errors(x, offsets, weight, bias, groups, dy) -> Dict:
    """K5' (:func:`~mm_training_tpu_torch.ops.deform_conv.
    deform_conv3x3_backward`) against its plain versions, with the bounds
    of this module's docstring: d x and d offsets against
    :func:`deform_cols_reference`, d weight and d bias against autograd
    through the plain forward in float64; d offsets, d weight and d bias the
    same bits on a second call."""
    dx, doff, dw, db = deform_conv.deform_conv3x3_backward(dy, x, offsets, weight, bias, groups)
    again = deform_conv.deform_conv3x3_backward(dy, x, offsets, weight, bias, groups)
    (ref_dx, mag_x, flip_x), (ref_doff, mag_off, flip_off) = deform_cols_reference(
        dy, x, offsets, weight, groups, x.dtype)
    out = {'d_x': outside(dx, ref_dx, mag_x, flip_x),
           'd_offsets': outside(doff, ref_doff, mag_off, flip_off)}
    ref = deform_conv.deform_conv3x3_backward_plain(dy.double(), x.double(), offsets,
                                                    weight.double(), bias.double(), groups)
    rel = 2.0 ** -7 if x.dtype == torch.bfloat16 else ORDER
    for name, got, want in (('d_weight', dw, ref[2]), ('d_bias', db, ref[3])):
        err = (got.float() - want).abs().max().item()
        top = want.abs().max().item()
        out[name] = {'max_abs_err': err, 'of_largest': err / max(top, 1e-30),
                     'ok': err <= rel * top}
    out['deterministic'] = all(torch.equal(a, b) for a, b in zip(again[1:], (doff, dw, db)))
    out['max_abs_err'] = max(out['d_x']['max_abs_err'], out['d_offsets']['max_abs_err'])
    out['ok'] = (out['d_x']['outside'] == 0 and out['d_offsets']['outside'] == 0
                 and out['d_weight']['ok'] and out['d_bias']['ok'] and out['deterministic']
                 and dx.dtype == x.dtype and doff.dtype == torch.float32
                 and dw.dtype == weight.dtype and db.dtype == bias.dtype)
    return out
