"""Kernels A', K4, K5, K1, K6, K2, K5', K4', K7', K8/K8' and K1's sparse
mode of this package against another copy of it, in one process.

The other copy (for example an earlier commit unpacked with ``git archive``
into a git-ignored directory) is imported under another module name and
builds its own ``csrc`` into its own ``_build/``. Each case is timed with
:func:`~mm_training_tpu_torch.exps.timing.device_ms` in the order other,
this, this, other, on the same inputs:

- A' at every distinct shape one B=4 ``lidar_radar`` train step launches
  (recorded as ``exps/profile_kernels.py`` records them), at [4,64,64,512]
  bf16 with and without a residual, and at ResNet-50's [4,2048,22,40] bf16
  (a copy that refuses it gets ``null``);
- K4 at the B=1 and the B=4 ``lidar_cam_radar`` request's splat indices,
  bf16, in every layout of ``exps/kernel_inputs.py``: the strided views the
  camera path hands over (depth channels-last, a slice read in place or
  NCHW; ctx a permuted channels-last slice) and contiguous copies;
- K5 as ``DeformConv2d.forward`` (offset conv included) under
  ``inference_mode`` at the B=1 and the B=4 ``lidar_cam_radar`` request's
  DCN input ([4 or 16, 512, 44, 80] bf16), the same weights and a random
  offset conv in both copies, with each forward's peak device memory above
  what it was handed;
- K1 as the LiDAR encoder's input stage at a B=1 and a B=4 ``lidar_radar``
  batch (100k points a frame): each copy's voxelization, cast and
  space-to-depth as its ``LidarBEVEncoder.forward`` runs them, in bf16, and
  the first conv's forward and backward (a weight gradient) on that input,
  each copy at its own input channels;
- the peak device memory of one B=4 ``lidar_cam_radar`` predict request,
  each copy's full-width model (seeded random weights) built in turn;
- K6 as ``depth_labels`` on the B=1 and the B=4 ``lidar_cam_radar``
  request's points and rig (the matrices as the strided views the path
  hands over), and ``depth_grid_to_onehot`` on a [4, 44, 80] grid, each
  copy's labels held equal;
- K2 as ``draw_heatmap`` on a B=4 ``lidar_radar`` train batch's targets,
  the two copies' maps held equal bit for bit there and on every case of
  ``exps/kernel_inputs.py::heatmap_case``;
- K5' as ``deform_conv3x3_backward`` (the DCN's whole backward) at the B=1
  and the B=4 camera train step's DCN ([4 or 16, 44, 80, 512] bf16, 4
  groups), offsets up to 3 px and at whole pixels (the train path's), with
  each call's peak device memory above what it was handed;
- K4' as ``lift_splat_factorized_backward`` at the B=1 and the B=4 camera
  train step's splat (the fake rig's indices, bf16, depth channels-last as
  under the depth oracle and NCHW without it);
- K7' as ``warp_backward`` at the B=1 and the B=4 camera BEV ([B, 32, 256,
  80] bf16) under a rotated, flipped and scaled BEV augmentation;
- K8 and K8' as ``lift_splat`` and ``lift_splat_backward`` at the B=1 and
  the B=4 raw-rig splat (the fake rig pitched by 3 degrees, bf16, depth
  channels-last and NCHW), with the bound of each; a copy without them gets
  ``null``;
- K1's sparse-input mode as ``sparse_encoder_input`` at B=1 and B=4 on the
  frames of ``exps/ablate_backward.py::sparse_inputs`` (100k points a
  frame: LiDAR-like, uniform, LiDAR-like with 20,000 points in one pillar),
  caps 15 and 1, bf16 into the sparse encoder's 16 channels, with its
  bound; the two copies' kept sets and occupancies held equal.

``--only`` takes a subset of {backward, lift_splat, deform_conv,
encoder_input, camera_memory, depth_labels, heatmap, deform_backward,
splat_backward, warp_backward, raw_splat, sparse_input}. ``--raw-rig`` measures
``camera_memory`` on the raw-rig model (the general splat, the pitched rig;
a copy that refuses it gets ``null``). Prints one JSON object with the
card's name and power limit.

    python -m mm_training_tpu_torch.exps.ab_kernels --other path/to/mm_training_tpu_torch
        [--only depth_labels heatmap] [--raw-rig]
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..configs import lidar_cam_radar, lidar_radar, raw_rig
from ..data import make_fake_batch, random_bda_matrices
from ..models import BEVDepthLiDAR
from ..models.centerpoint_head import heatmap_inputs
from ..models.depth_net import DeformConv2d
from ..models.lidar_encoder import LidarBEVEncoder
from ..ops import (affine_act, deform_conv, depth_labels, gaussian, voxel_pooling, voxelize,
                   warp)
from ..training import create_train_state, make_train_step
from .kernel_inputs import (HEATMAP_CASES, SPLAT_LAYOUTS, deform_inputs, deform_shape,
                            depth_label_inputs, heatmap_case, raw_splat_inputs, splat_inputs)
from .profile_kernels import record
from .profile_train import RAW_RIG_PITCH_DEG
from .timing import HBM_BYTES_PER_S, device_ms

__all__ = ['main']

SECTIONS = ('backward', 'lift_splat', 'deform_conv', 'encoder_input', 'camera_memory',
            'depth_labels', 'heatmap', 'deform_backward', 'splat_backward', 'warp_backward',
            'raw_splat', 'sparse_input')


def load_copy(path: str, name: str = 'mm_training_tpu_torch_other'):
    """The package copy at ``path``, imported as ``name``; its submodules
    by ``importlib.import_module(f'{name}.ops.affine_act')`` and so on."""
    path = Path(path).resolve()
    spec = importlib.util.spec_from_file_location(name, path / '__init__.py',
                                                  submodule_search_locations=[str(path)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return name


def _alternate(other, this, iters: int) -> dict:
    """Device ms of other, this, this, other; ``None`` for a side that raises
    or that is ``None`` (a copy without the function)."""
    def timed(fn):
        if fn is None:
            return None
        try:
            return device_ms(fn, iters)
        except (ValueError, RuntimeError) as e:
            print(f'  refused: {e}', flush=True)
            return None
    o1, t1, t2, o2 = timed(other), timed(this), timed(this), timed(other)
    return {'other_ms': [o1, o2], 'this_ms': [t1, t2]}


def backward_shapes() -> list:
    """(shape, residual, relu, launches) of every A' call of one B=4
    ``lidar_radar`` train step, bf16."""
    cfg = lidar_radar(batch_size=4, max_points_per_frame=100_000)
    model = BEVDepthLiDAR(cfg, generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    batch = make_fake_batch(cfg, seed=0)
    step(state, batch)
    calls = record(lambda: step(state, batch))
    return sorted((list(k[1]), k[3], k[4], n) for k, n in calls.items() if k[0] == 'backward')


def _peak_above(fn) -> float:
    """GiB of device memory ``fn()`` held at its peak above what was
    allocated before it (after a warm call)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def deform_conv_rows(other: str, gen: torch.Generator) -> list:
    """K5: ``DeformConv2d.forward`` of both copies at the B=1 and B=4
    requests' DCN input, the same weights and offset conv."""
    other_dcn = importlib.import_module(f'{other}.models.depth_net').DeformConv2d
    rows = []
    for batch_size in (1, 4):
        cfg = lidar_cam_radar(batch_size=batch_size)
        bb = cfg.get_backbone_conf()
        c = bb.depth_net_conf.mid_channels
        this = DeformConv2d(c, c, groups=4)
        this.reset_parameters(torch.Generator().manual_seed(0))
        with torch.no_grad():   # offsets of about 1-2 px, as chip_smoke.py draws them
            w = this.conv_offset.weight
            w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(1))
                    / (w.shape[1] * 9) ** 0.5)
        that = other_dcn(c, c, groups=4)
        that.load_state_dict(this.state_dict())
        mods = [m.to('cuda', torch.bfloat16).to(memory_format=torch.channels_last).eval()
                for m in (this, that)]
        x = torch.randn(batch_size * cfg.num_cameras, c, *bb.feat_hw, generator=gen,
                        device='cuda').bfloat16().contiguous(memory_format=torch.channels_last)
        row = {'batch_size': batch_size, 'input': list(x.shape)}
        with torch.inference_mode():
            row.update(_alternate(lambda: mods[1](x), lambda: mods[0](x), 20))
            row['this_peak_gib'] = _peak_above(lambda: mods[0](x))
            row['other_peak_gib'] = _peak_above(lambda: mods[1](x))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def encoder_input_rows(other: str, gen: torch.Generator) -> list:
    """K1: the LiDAR encoder's input stage of both copies, and its first
    conv's forward and backward on that input."""
    other_vox = importlib.import_module(f'{other}.ops.voxelize')
    other_s2d = importlib.import_module(f'{other}.models.resnet').space_to_depth_2x2
    rows = []
    for batch_size in (1, 4):
        cfg = lidar_radar(batch_size=batch_size, max_points_per_frame=100_000)
        batch = make_fake_batch(cfg, seed=0)
        pts = torch.as_tensor(batch['points'], device='cuda')
        mask = torch.as_tensor(batch['point_mask'], device='cuda')
        geo = (cfg.point_cloud_range, cfg.voxel_size, cfg.out_shape)
        enc = LidarBEVEncoder(cfg.get_lidar_conf(), *geo).to(
            'cuda', torch.bfloat16).to(memory_format=torch.channels_last)
        nf = cfg.get_lidar_conf().voxelization.num_features

        def that_stage():
            x = other_vox.voxelize_pillars_dense(pts, mask, *geo, num_features=nf)
            return other_s2d(x.to(torch.bfloat16)).permute(0, 3, 1, 2)

        def this_stage():
            return voxelize.pillar_encoder_input(
                pts, mask, *geo, num_features=nf, dtype=torch.bfloat16,
                space_to_depth=enc.conf.space_to_depth,
                channels=enc.input_channels).permute(0, 3, 1, 2)
        row = {'batch_size': batch_size, 'points': list(pts.shape),
               'this_channels': enc.input_channels}
        row.update(_alternate(that_stage, this_stage, 50))
        conv = enc.stage0_conv0.conv
        x_that, x_this = that_stage(), this_stage()
        g = torch.randn(x_this.shape[0], conv.out_channels, *x_this.shape[2:], generator=gen,
                        device='cuda').bfloat16().contiguous(memory_format=torch.channels_last)

        def that_conv():
            conv.weight.grad = None
            F.conv2d(x_that, conv.weight, None, 1, 1).backward(g)

        def this_conv():
            conv.weight.grad = None
            F.conv2d(x_this, enc.first_conv_weight(), None, 1, 1).backward(g)
        conv_ab = _alternate(that_conv, this_conv, 20)
        row['conv_other_ms'], row['conv_this_ms'] = conv_ab['other_ms'], conv_ab['this_ms']
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def camera_memory(other: str, raw: bool = False) -> dict:
    """GiB of device memory one B=4 ``lidar_cam_radar`` predict request held
    at its peak above the model, for each copy's own model; with ``raw``
    the raw-rig model on the pitched rig (``null`` for a copy that refuses
    it)."""
    out = {'raw_rig': raw}
    cfg = lidar_cam_radar(batch_size=4)
    if raw:
        cfg = raw_rig(cfg)
    batch = make_fake_batch(cfg, seed=0, pitch_deg=RAW_RIG_PITCH_DEG if raw else 0.0)
    for label, pkg in (('other', other), ('this', __package__.split('.')[0])):
        try:
            model = importlib.import_module(f'{pkg}.models').BEVDepthLiDAR(
                cfg, generator=torch.Generator().manual_seed(0))
        except NotImplementedError as e:
            print(f'  {label} refused: {e}', flush=True)
            out[f'{label}_request_peak_gib'] = None
            continue
        predict = importlib.import_module(f'{pkg}.training').make_predict_step(cfg, model)
        out[f'{label}_request_peak_gib'] = _peak_above(lambda: [o.cpu() for o in predict(batch)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[f'{label}_held_gib'] = torch.cuda.memory_allocated() / 2 ** 30
        [o.cpu() for o in predict(batch)]
        out[f'{label}_peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
        del model, predict
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


def depth_label_rows(other: str, gen: torch.Generator) -> list:
    """K6: ``depth_labels`` of both copies on the B=1 and the B=4 requests
    (the matrices as the path's strided views), and
    ``depth_grid_to_onehot`` on a [4, 44, 80] grid."""
    other_dl = importlib.import_module(f'{other}.ops.depth_labels')
    rows = []
    for batch_size in (1, 4):
        args = depth_label_inputs(lidar_cam_radar(batch_size=batch_size), 'cuda')
        mask, extr = args[1], args[2]
        out = depth_labels.depth_labels(*args)
        # the mask, x y z of the kept points and the matrices read, the
        # labels written
        nbytes = mask.numel() + int(mask.sum()) * 12 + 2 * extr[..., 0, 0].numel() * 64 \
            + out.numel() * 4
        row = {'kernel': 'depth_labels', 'batch_size': batch_size, 'shape': list(out.shape),
               'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3,
               'equal_to_other': torch.equal(out, other_dl.depth_labels(*args))}
        row.update(_alternate(lambda: other_dl.depth_labels(*args),
                              lambda: depth_labels.depth_labels(*args), 50))
        rows.append(row)
        print(json.dumps(row), flush=True)
    bb = lidar_cam_radar().get_backbone_conf()
    grid = torch.rand(4, *bb.feat_hw, generator=gen, device='cuda') * 220
    grid_args = (grid, bb.d_bound, bb.depth_channels)
    out = depth_labels.depth_grid_to_onehot(*grid_args)
    row = {'kernel': 'depth_grid_to_onehot', 'shape': list(out.shape),
           'bound_ms': (grid.numel() + out.numel()) * 4 / HBM_BYTES_PER_S * 1e3,
           'equal_to_other': torch.equal(out, other_dl.depth_grid_to_onehot(*grid_args))}
    row.update(_alternate(lambda: other_dl.depth_grid_to_onehot(*grid_args),
                          lambda: depth_labels.depth_grid_to_onehot(*grid_args), 50))
    rows.append(row)
    print(json.dumps(row), flush=True)
    return rows


def heatmap_rows(other: str) -> dict:
    """K2: ``draw_heatmap`` of both copies on a B=4 ``lidar_radar`` train
    batch's targets, timed; the maps held equal bit for bit there and on
    every edge case of ``heatmap_case``."""
    other_g = importlib.import_module(f'{other}.ops.gaussian')
    cfg = lidar_radar(batch_size=4)
    tb = make_fake_batch(cfg, seed=0)
    args = heatmap_inputs(cfg.get_head_conf(), torch.as_tensor(tb['gt_boxes'], device='cuda'),
                          torch.as_tensor(tb['gt_labels'], device='cuda').long(),
                          torch.as_tensor(tb['gt_mask'], device='cuda'))
    out = gaussian.draw_heatmap(*args)
    centers, radii, valid, _ = args
    row = {'kernel': 'draw_heatmap', 'shape': list(out.shape),
           'windows': int(valid.sum()),
           'bound_ms': (out.numel() * 4 + centers.numel() * 4 + radii.numel() * 4
                        + valid.numel()) / HBM_BYTES_PER_S * 1e3,
           'equal_to_other': torch.equal(out, other_g.draw_heatmap(*args)),
           'second_call_equal': torch.equal(out, gaussian.draw_heatmap(*args))}
    for case in HEATMAP_CASES:
        c, r, v, hw = heatmap_case(case)
        a = (*(torch.from_numpy(x).cuda() for x in (c, r, v)), hw)
        row[f'equal_to_other_{case}'] = torch.equal(gaussian.draw_heatmap(*a),
                                                    other_g.draw_heatmap(*a))
    row.update(_alternate(lambda: other_g.draw_heatmap(*args),
                          lambda: gaussian.draw_heatmap(*args), 100))
    print(json.dumps(row), flush=True)
    return row


def deform_backward_rows(other: str, gen: torch.Generator) -> list:
    """K5': ``deform_conv3x3_backward`` of both copies at the B=1 and the
    B=4 camera train step's DCN, offsets up to 3 px and at whole pixels."""
    other_dc = importlib.import_module(f'{other}.ops.deform_conv')
    rows = []
    for batch_size in (1, 4):
        shape = deform_shape(lidar_cam_radar(batch_size=batch_size))
        for reach in (3.0, 0.0):
            x, off, wgt, bias = deform_inputs(shape, 4, gen, torch.bfloat16, reach)
            dy = torch.randn(*shape[:3], wgt.shape[0] * wgt.shape[2], generator=gen,
                             device='cuda').bfloat16()
            a = (dy, x, off, wgt, bias, 4)
            row = {'batch_size': batch_size, 'shape': list(shape), 'offsets_px': reach}
            row.update(_alternate(lambda: other_dc.deform_conv3x3_backward(*a),
                                  lambda: deform_conv.deform_conv3x3_backward(*a), 10))
            row['this_peak_gib'] = _peak_above(lambda: deform_conv.deform_conv3x3_backward(*a))
            row['other_peak_gib'] = _peak_above(lambda: other_dc.deform_conv3x3_backward(*a))
            rows.append(row)
            print(json.dumps(row), flush=True)
            del x, off, wgt, bias, dy, a
    return rows


def splat_backward_rows(other: str, gen: torch.Generator) -> list:
    """K4': ``lift_splat_factorized_backward`` of both copies at the B=1
    and the B=4 camera train step's splat, depth channels-last and NCHW."""
    other_vp = importlib.import_module(f'{other}.ops.voxel_pooling')
    rows = []
    for batch_size in (1, 4):
        for layout in ('channels_last', 'nchw'):
            args = splat_inputs(lidar_cam_radar(batch_size=batch_size), gen, layout)
            depth, ctx, idx, zvalid, n_cells = args
            g = torch.randn(idx.shape[0], n_cells, ctx.shape[-1], generator=gen,
                            device='cuda').bfloat16()
            # depth and zvalid read and d depth written, ctx read and d ctx
            # written, the indices and g read once
            nbytes = (depth.numel() * 2 * 2 + zvalid.numel() + ctx.numel() * 2 * 2
                      + idx.numel() * 4 + g.numel() * 2)
            row = {'batch_size': batch_size, 'layout': layout, 'cameras': idx.shape[0],
                   'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3}
            row.update(_alternate(lambda: other_vp.lift_splat_factorized_backward(g, *args),
                                  lambda: voxel_pooling.lift_splat_factorized_backward(g, *args),
                                  20))
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def warp_backward_rows(other: str, gen: torch.Generator) -> list:
    """K7': ``warp_backward`` of both copies on the B=1 and the B=4 camera
    BEV (bf16) under a rotated, flipped and scaled BEV augmentation."""
    other_warp = importlib.import_module(f'{other}.ops.warp')
    rows = []
    for batch_size in (1, 4):
        bb = lidar_cam_radar(batch_size=batch_size).get_backbone_conf()
        img = torch.randn(batch_size, *bb.bev_hw, bb.output_channels, generator=gen,
                          device='cuda').bfloat16()
        g = torch.randn(img.shape, generator=gen, device='cuda').bfloat16()
        bda = torch.as_tensor(random_bda_matrices(batch_size, 31), device='cuda')
        row = {'batch_size': batch_size, 'shape': list(img.shape),
               'bound_ms': (2 * img.numel() * 2 + bda.numel() * 4) / HBM_BYTES_PER_S * 1e3}
        row.update(_alternate(lambda: other_warp.warp_backward(g, img, bda, 4),
                              lambda: warp.warp_backward(g, img, bda, 4), 50))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def raw_splat_rows(other: str, gen: torch.Generator) -> list:
    """K8 and K8': ``lift_splat`` and ``lift_splat_backward`` of both copies
    at the B=1 and the B=4 raw-rig splat, depth channels-last and NCHW."""
    other_vp = importlib.import_module(f'{other}.ops.voxel_pooling')
    that_fwd = getattr(other_vp, 'lift_splat', None)
    that_bwd = getattr(other_vp, 'lift_splat_backward', None)
    rows = []
    for batch_size in (1, 4):
        for layout in ('channels_last', 'nchw'):
            depth, ctx, idx, n_cells = a = raw_splat_inputs(
                lidar_cam_radar(batch_size=batch_size), gen, layout)
            g = torch.randn(idx.shape[0], n_cells, ctx.shape[-1], generator=gen,
                            device='cuda').bfloat16()
            out_bytes = g.numel() * 2
            row = {'batch_size': batch_size, 'layout': layout, 'cameras': idx.shape[0],
                   'bound_ms': (depth.numel() * 2 + ctx.numel() * 2 + idx.numel() * 4
                                + out_bytes) / HBM_BYTES_PER_S * 1e3,
                   'backward_bound_ms': (depth.numel() * 2 * 2 + ctx.numel() * 2 * 2
                                         + idx.numel() * 4 + g.numel() * 2)
                   / HBM_BYTES_PER_S * 1e3}
            row['forward'] = _alternate(that_fwd and (lambda: that_fwd(*a)),
                                        lambda: voxel_pooling.lift_splat(*a), 20)
            row['backward'] = _alternate(that_bwd and (lambda: that_bwd(g, *a)),
                                         lambda: voxel_pooling.lift_splat_backward(g, *a), 20)
            rows.append(row)
            print(json.dumps(row), flush=True)
            del depth, ctx, idx, g, a
    return rows


def sparse_input_rows(other: str) -> list:
    """K1's sparse mode: ``sparse_encoder_input`` of both copies at B=1 and
    B=4 on each frame of ``sparse_inputs``, caps 15 and 1, bf16 into 16
    channels; the kept sets and occupancies of the copies held equal."""
    from .ablate_backward import sparse_inputs
    other_vox = importlib.import_module(f'{other}.ops.voxelize')
    cfg = lidar_radar()
    geo = (cfg.point_cloud_range, cfg.voxel_size, cfg.out_shape)
    nf = cfg.get_lidar_conf().voxelization.num_features
    rows = []
    for (batch_size, frame), (pts, mask) in sparse_inputs().items():
        for cap in (15, 1):
            a = (pts, mask, *geo, nf, torch.bfloat16, 16)
            kw = dict(max_points_per_voxel=cap)
            grid, occ, kept = voxelize.sparse_encoder_input(*a, **kw, return_kept=True)
            _, that_occ, that_kept = other_vox.sparse_encoder_input(*a, **kw, return_kept=True)
            # the mask, the xyz of each masked-in point, the other features of
            # each kept one, the grid and the occupancy out
            nbytes = (mask.numel() + int(mask.sum()) * 3 * 4 + int(kept.sum()) * (nf - 3) * 4
                      + grid.numel() * 2 + occ.numel())
            row = {'batch_size': batch_size, 'frame': frame, 'cap': cap,
                   'kept': int(kept.sum()), 'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3,
                   'kept_equal_to_other': torch.equal(kept, that_kept),
                   'occ_equal_to_other': torch.equal(occ, that_occ)}
            row.update(_alternate(lambda: other_vox.sparse_encoder_input(*a, **kw),
                                  lambda: voxelize.sparse_encoder_input(*a, **kw), 20))
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--other', required=True, help='directory of the other package copy')
    ap.add_argument('--only', nargs='+', choices=SECTIONS, default=SECTIONS)
    ap.add_argument('--raw-rig', action='store_true',
                    help='camera_memory on the raw-rig model and the pitched rig')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('ab_kernels: needs a CUDA device')
    other = load_copy(args.other)
    gen = torch.Generator(device='cuda').manual_seed(0)
    result = {'device': torch.cuda.get_device_name(0),
              'card': subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                                      '--format=csv,noheader'], capture_output=True,
                                     text=True).stdout.strip(),
              'backward': [], 'lift_splat': []}
    if 'deform_conv' in args.only:
        result['deform_conv'] = deform_conv_rows(other, gen)
    if 'encoder_input' in args.only:
        result['encoder_input'] = encoder_input_rows(other, gen)
    if 'camera_memory' in args.only:
        result['camera_memory'] = camera_memory(other, args.raw_rig)
    if 'depth_labels' in args.only:
        result['depth_labels'] = depth_label_rows(other, gen)
    if 'heatmap' in args.only:
        result['heatmap'] = heatmap_rows(other)
    if 'deform_backward' in args.only:
        result['deform_backward'] = deform_backward_rows(other, gen)
    if 'splat_backward' in args.only:
        result['splat_backward'] = splat_backward_rows(other, gen)
    if 'warp_backward' in args.only:
        result['warp_backward'] = warp_backward_rows(other, gen)
    if 'raw_splat' in args.only:
        result['raw_splat'] = raw_splat_rows(other, gen)
    if 'sparse_input' in args.only:
        result['sparse_input'] = sparse_input_rows(other)
    other_aa = importlib.import_module(f'{other}.ops.affine_act')
    other_vp = importlib.import_module(f'{other}.ops.voxel_pooling')

    cases = []
    if 'backward' in args.only:
        cases = [(shape, res, relu, {'train B=4': n})
                 for shape, res, relu, n in backward_shapes()]
        cases += [([4, 64, 64, 512], False, True, {}), ([4, 64, 64, 512], True, True, {}),
                  ([4, 2048, 22, 40], True, True, {})]
    for shape, res, relu, launches in cases:
        def cl():
            return torch.randn(*shape, generator=gen, device='cuda').bfloat16().contiguous(
                memory_format=torch.channels_last)
        x, g, r = cl(), cl(), (cl() if res else None)
        s = torch.randn(shape[1], generator=gen, device='cuda')
        t = torch.randn(shape[1], generator=gen, device='cuda')
        row = {'shape': shape, 'residual': res, 'relu': relu, 'launches': launches,
               'bound_ms': (3 + 2 * res) * x.numel() * 2 / HBM_BYTES_PER_S * 1e3}
        row.update(_alternate(lambda: other_aa.affine_act_backward(g, x, s, t, r, relu),
                              lambda: affine_act.affine_act_backward(g, x, s, t, r, relu), 50))
        result['backward'].append(row)
        print(json.dumps(row), flush=True)

    for batch_size in ((1, 4) if 'lift_splat' in args.only else ()):
        for layout in SPLAT_LAYOUTS:
            a = splat_inputs(lidar_cam_radar(batch_size=batch_size), gen, layout)
            depth, ctx, idx, zvalid, n_cells = a
            nbytes = (depth.numel() * 2 + zvalid.numel() + ctx.numel() * 2 + idx.numel() * 4
                      + idx.shape[0] * n_cells * ctx.shape[-1] * 2)
            row = {'batch_size': batch_size, 'layout': layout,
                   'cameras': idx.shape[0], 'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3}
            row.update(_alternate(lambda: other_vp.lift_splat_factorized(*a),
                                  lambda: voxel_pooling.lift_splat_factorized(*a), 50))
            result['lift_splat'].append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
