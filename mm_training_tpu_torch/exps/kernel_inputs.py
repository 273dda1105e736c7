"""Kernel K4's, K8's, K5's and K6's inputs at a camera config's shapes, K4's
and K8's laid out as the path hands them over (``models/lss_fpn.py``), the
tolerance that holds the fused K5 to its plain version, and K2's edge cases.
Shared by ``chip_smoke.py``, the card tests, the CPU tests and
``exps/ab_kernels.py``."""
from __future__ import annotations

import numpy as np
import torch

from ..configs import Config
from ..data import make_fake_batch
from ..models.lss_fpn import LSSFPN
from ..ops import deform_conv

__all__ = ['HEATMAP_CASES', 'SPLAT_LAYOUTS', 'deform_inputs', 'deform_outside_tolerance',
           'deform_shape', 'depth_label_case', 'depth_label_inputs', 'heatmap_case',
           'raw_interval_stats', 'raw_splat_inputs', 'splat_inputs']

# 'channels_last': the softmax over bins in channels-last memory, as the depth
# oracle's ``where`` leaves it; 'slice': the softmax written into the
# DepthNet output and read in place; 'nchw': the softmax without the oracle;
# each with ctx the permuted channels-last slice of that output.
# 'contiguous': contiguous copies of both.
SPLAT_LAYOUTS = ('channels_last', 'slice', 'nchw', 'contiguous')


def splat_inputs(cfg: Config, gen: torch.Generator, layout: str = 'channels_last',
                 dtype: torch.dtype = torch.bfloat16, seed: int = 8):
    """(depth, ctx, idx, zvalid, n_cells) on ``gen``'s device: the fake rig's
    own splat indices and z mask for ``cfg``'s batch (fake batch ``seed``)
    and a random DepthNet output of ``dtype`` from ``gen``, depth and ctx in
    one of :data:`SPLAT_LAYOUTS`."""
    if layout not in SPLAT_LAYOUTS:
        raise ValueError(f'splat_inputs: layout one of {SPLAT_LAYOUTS}, got {layout!r}')
    dev = gen.device
    bb = cfg.get_backbone_conf()
    batch = make_fake_batch(cfg, seed=seed)
    with torch.device('meta'):
        lss = LSSFPN(bb)
    idx, zvalid = lss.splat_indices(torch.as_tensor(batch['sensor2ego'][:, 0], device=dev),
                                    torch.as_tensor(batch['intrin'][:, 0], device=dev))
    d, (fh, fw), c = bb.depth_channels, bb.feat_hw, bb.output_channels
    feat = torch.randn(idx.shape[0], d + c, fh, fw, generator=gen, device=dev).to(dtype)
    feat = feat.contiguous(memory_format=torch.channels_last)
    ctx = feat[:, d:].permute(0, 2, 3, 1)
    if layout == 'slice':
        depth = feat[:, :d]
        depth.copy_(depth.softmax(1))
    elif layout == 'nchw':
        depth = feat[:, :d].softmax(1).contiguous()
    else:
        depth = feat[:, :d].softmax(1).contiguous(memory_format=torch.channels_last)
        if layout == 'contiguous':
            depth, ctx = depth.contiguous(), ctx.contiguous()
    return depth, ctx, idx, zvalid, int(np.prod(bb.bev_hw))


def raw_splat_inputs(cfg: Config, gen: torch.Generator, layout: str = 'channels_last',
                     dtype: torch.dtype = torch.bfloat16, seed: int = 8,
                     pitch_deg: float = 3.0):
    """(depth [M, D, P], ctx [M, P, C], idx [M, D, P], n_cells) of kernel K8
    on ``gen``'s device: the raw splat indices of ``cfg``'s fake batch
    (``seed``) with every camera pitched by ``pitch_deg``, and a random
    DepthNet output of ``dtype`` from ``gen``, viewed as the raw-rig path
    views it: ctx the flattened permuted channels-last slice, depth the
    flattened softmax, channels-last (``layout`` 'channels_last', as the
    depth oracle's ``where`` leaves it) or NCHW ('nchw', without the
    oracle)."""
    if layout not in ('channels_last', 'nchw'):
        raise ValueError(f"raw_splat_inputs: layout 'channels_last' or 'nchw', got {layout!r}")
    dev = gen.device
    bb = cfg.get_backbone_conf()
    batch = make_fake_batch(cfg, seed=seed, pitch_deg=pitch_deg)
    with torch.device('meta'):
        lss = LSSFPN(bb)
    idx = lss.raw_splat_indices(torch.as_tensor(batch['sensor2ego'][:, 0], device=dev),
                                torch.as_tensor(batch['intrin'][:, 0], device=dev))
    d, (fh, fw), c = bb.depth_channels, bb.feat_hw, bb.output_channels
    feat = torch.randn(idx.shape[0], d + c, fh, fw, generator=gen, device=dev).to(dtype)
    feat = feat.contiguous(memory_format=torch.channels_last)
    ctx = feat[:, d:].permute(0, 2, 3, 1).flatten(1, 2)
    depth = feat[:, :d].softmax(1)
    depth = (depth.contiguous(memory_format=torch.channels_last) if layout == 'channels_last'
             else depth.contiguous()).flatten(2)
    return depth, ctx, idx, int(np.prod(bb.bev_hw))


def raw_interval_stats(idx: torch.Tensor, n_cells: int) -> dict:
    """The entries a (camera, cell) interval of the raw splat holds for the
    index ``idx`` [M, D, P] (``n_cells`` = off the grid): the kept rows,
    the cells with and without entries, and the entries a non-empty cell
    has at most, at the 99th percentile and on average."""
    m = idx.shape[0]
    cell = idx.reshape(m, -1).long() + (n_cells + 1) * torch.arange(m, device=idx.device)[:, None]
    counts = torch.bincount(cell.reshape(-1), minlength=m * (n_cells + 1))
    counts = counts.reshape(m, n_cells + 1)[:, :n_cells].reshape(-1)
    full = counts[counts > 0].double()
    return {'kept_rows': int(counts.sum()), 'cells': int(counts.numel()),
            'non_empty_cells': int(full.numel()),
            'max': int(full.max()) if full.numel() else 0,
            'p99': float(torch.quantile(full, 0.99)) if full.numel() else 0.0,
            'mean_non_empty': float(full.mean()) if full.numel() else 0.0}


def deform_shape(cfg: Config):
    """(B * cameras, fH, fW, C) of the DepthNet's deformable conv input at
    ``cfg``'s batch: 4 x 44 x 80 x 512 for a ``lidar_cam_radar`` request."""
    bb = cfg.get_backbone_conf()
    return (cfg.batch_size * cfg.num_cameras, *bb.feat_hw, bb.depth_net_conf.mid_channels)


def deform_inputs(shape, groups: int, gen: torch.Generator,
                  dtype: torch.dtype = torch.bfloat16, max_offset: float = 3.0):
    """(x, offsets, weight, bias) of :func:`~mm_training_tpu_torch.ops.
    deform_conv.deform_conv3x3` on ``gen``'s device: x [B, H, W, C] N(0, 1)
    in ``dtype``; offsets uniform in [-max_offset, max_offset] px with a
    quarter snapped to whole pixels; a He-scaled kernel (C -> C) packed for
    the fused op and a N(0, 0.1) bias, both in ``dtype``."""
    b, h, w, c = shape
    dev = gen.device
    x = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
    off = (torch.rand(b, h, w, 18, generator=gen, device=dev) * 2 - 1) * max_offset
    snap = torch.rand(off.shape, generator=gen, device=dev) < 0.25
    off = torch.where(snap, off.round(), off)
    kernel = torch.randn(c, c // groups, 3, 3, generator=gen, device=dev) * (
        2.0 / (9 * c // groups)) ** 0.5
    weight = deform_conv.pack_weight(kernel, groups, dtype)
    bias = (torch.randn(c, generator=gen, device=dev) * 0.1).to(dtype)
    return x, off, weight, bias


def deform_outside_tolerance(got: torch.Tensor, x, offsets, weight, bias, groups: int):
    """(entries of ``got`` or of the plain version outside the tolerance,
    max |got - plain|) for :func:`~mm_training_tpu_torch.ops.deform_conv.
    deform_conv3x3` on these inputs. The samples are exact (the plain
    columns, bit for bit); the fp32 sums over (tap, C/g) may run in any
    order, which moves a sum by at most 1e-5 of its sum of |terms|. So an
    output is right when it is the op's own rounding of some sum within that
    bound of the exact (float64) sum: the sum rounded to x's dtype, then
    the bias added in x's dtype. Each rounding is monotone, so that is the
    range between the outputs of the two ends of the bound."""
    b, h, w, c = x.shape
    cols = deform_conv.deform_sample_plain(x, offsets).double()
    cols = cols.reshape(b * h * w, 9, groups, c // groups).permute(2, 0, 1, 3)
    cols = cols.reshape(groups, b * h * w, -1)
    wd = weight.double()
    exact = torch.bmm(cols, wd)
    slack = 1e-5 * torch.bmm(cols.abs(), wd.abs())
    bias = bias.to(x.dtype)

    def rounded(s):   # the op's roundings of an fp32 sum s
        s = s.permute(1, 0, 2).reshape(b, h, w, -1).float().to(x.dtype)
        return s + bias
    lo, hi = rounded(exact - slack), rounded(exact + slack)
    plain = deform_conv.deform_conv3x3_plain(x, offsets, weight, bias, groups)
    outside = sum(int(((v < lo) | (v > hi)).sum()) for v in (got, plain))
    return outside, (got.float() - plain.float()).abs().max().item()


def depth_label_inputs(cfg: Config, device, seed: int = 8) -> tuple:
    """Kernel K6's arguments for ``cfg``'s fake batch (``seed``) as the
    camera path hands them over: the points [B, P, F] (the identity BDA
    leaves x, y, z as they are), the mask, the key frame's extrinsics and
    intrinsics as strided [B, N, 4, 4] views, then the image size,
    downsample, depth bounds and bins."""
    bb = cfg.get_backbone_conf()
    batch = make_fake_batch(cfg, seed=seed)
    pts, mask, extr, intr = (torch.as_tensor(batch[k], device=device) for k in
                             ('points', 'point_mask', 'extrinsics', 'intrin'))
    return (pts, mask, extr[:, 0], intr[:, 0], cfg.final_dim, bb.downsample_factor,
            bb.d_bound, bb.depth_channels)


def depth_label_case(name: str, hw=(64, 128), seed: int = 0):
    """(points [1, P, 8], mask [1, P], extrinsics, intrinsics [1, 2, 4, 4])
    float32 / bool numpy arrays of a two-camera rig whose body frame is
    both cameras' frame, for an ``hw`` image:

    - 'p2_zero': camera 0's third intrinsic row is (0, 0, 1, -5), so a point
      at depth 5 has p2 == 0 and the division takes 1e-9 (the point at
      (1e-8, 2e-8, 5) lands at pixel (10, 20), the one at (0, 0, 5) at 0 and
      is dropped); camera 1 is a pinhole (f 20, principal point at the
      image centre); plus 400 random points at depths 0.5-30 and one NaN
      point;
    - 'none_kept': the same points with the mask all False (every cell
      empty, bin 0)."""
    if name not in ('p2_zero', 'none_kept'):
        raise ValueError(f"depth_label_case: 'p2_zero' or 'none_kept', got {name!r}")
    h, w = hw
    rng = np.random.default_rng(seed)
    pts = np.zeros((1, 404, 8), np.float32)
    z = rng.uniform(0.5, 30.0, 400)
    pts[0, 4:, 0] = rng.uniform(-0.6, 0.6, 400) * z * w / 40
    pts[0, 4:, 1] = rng.uniform(-0.6, 0.6, 400) * z * h / 40
    pts[0, 4:, 2] = z
    pts[0, :4, :3] = [[1e-8, 2e-8, 5.0], [0.0, 0.0, 5.0], [np.nan, 0.0, 5.0],
                      [3.0, 1.0, 7.0]]
    extr = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    intr = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    intr[0, 0, 2, 3] = -5.0
    intr[0, 1, :2, :3] = [[20.0, 0.0, w / 2], [0.0, 20.0, h / 2]]
    mask = np.full((1, 404), name == 'p2_zero')
    return pts, mask, extr, intr


# kernel K2's edge cases (numpy, so the JAX function can take them too)
HEATMAP_CASES = ('band_edges', 'off_map', 'r_zero', 'huge_radius', 'no_valid_map',
                 'many_slots', 'odd_width')


def heatmap_case(name: str, seed: int = 0):
    """(centers [B, K, 2] int32, radii [B, K] int32, valid [B, M, K] bool,
    (H, W)) of one of :data:`HEATMAP_CASES`:

    - 'band_edges': 64 x 512 maps (8-row bands of 4096 cells), centres on
      rows 7, 8, 15, 16 and the first and last rows, so windows straddle the
      edges of the kernel's bands;
    - 'off_map': centres left of, right of, above and below the map, some
      windows reaching in and some not;
    - 'r_zero': radius 0 (a single cell) for most objects;
    - 'huge_radius': radii larger than the map beside ordinary ones;
    - 'no_valid_map': one map of each sample where no object is valid;
    - 'many_slots': 1,500 slots, more than one staging chunk of 256;
    - 'odd_width': 23 x 37 maps, whose rows and maps are not 16-byte
      aligned."""
    if name not in HEATMAP_CASES:
        raise ValueError(f'heatmap_case: one of {HEATMAP_CASES}, got {name!r}')
    rng = np.random.default_rng(seed)
    b, m, k, (h, w) = 2, 3, 40, (64, 512)
    if name == 'many_slots':
        b, m, k = 1, 2, 1500
    if name == 'odd_width':
        h, w = 23, 37
    centers = np.stack([rng.integers(0, w, (b, k)), rng.integers(0, h, (b, k))], -1)
    radii = rng.integers(1, 7, (b, k))
    valid = rng.random((b, m, k)) < 0.5
    if name == 'band_edges':
        rows = np.array([7, 8, 15, 16, 0, h - 1, 23, 24])
        centers[:, :24, 1] = np.resize(rows, 24)
    elif name == 'off_map':
        centers[:, 0:12, 0] = [-1, -3, -9, w, w + 2, w + 9, 5, 9, 100, 200, -2, w + 1]
        centers[:, 0:12, 1] = [5, 6, 7, 8, 9, 10, -1, -4, h, h + 3, -2, h + 1]
        radii[:, 0:12] = [2, 4, 3, 1, 3, 5, 2, 5, 1, 6, 3, 2]
        valid[:, :, :12] = True
    elif name == 'r_zero':
        radii[:, : 3 * k // 4] = 0
    elif name == 'huge_radius':
        radii[:, :3] = [1000, w + 5, 4 * w]
        valid[:, :, :3] = True
    elif name == 'no_valid_map':
        valid[:, 1] = False
    return (centers.astype(np.int32), radii.astype(np.int32), valid, (h, w))
