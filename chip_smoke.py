#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mm_training_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root, one NVIDIA H100

Phases, each raising on failure:
  1. build the eleven CUDA sources of ``mm_training_tpu_torch/csrc`` (one
     nvcc per source, in parallel) and print the build time; then count
     the device operations of one K3, K7, A', fused K5, K1 encoder-input,
     K6 (``depth_labels`` at the B=1 and the B=4 camera request,
     ``depth_grid_to_onehot`` on a [4, 44, 80] grid) and K2 (the B=4 train
     batch's targets) call (torch.profiler): one kernel each, no copy, no
     fill; of one K4 call at the B=1 and the B=4 camera request's shapes:
     at most two; and of one call of each backward kernel and of the
     raw-rig splat at those shapes: K4', K7' (the gather), K8 and K8' one
     kernel each, the DCN's whole backward K5' at most three (two launches);
  2. hold each kernel against its plain PyTorch version at the serving and
     training paths' shapes (K3 also on dense rows, A' also at ResNet-50's
     2048-channel shape, K1 also into the encoder's input at B=1 and B=4,
     K2 also the same bits on a second call), and time kernel, plain
     version and, where one exists, a single PyTorch call computing the
     same function;
  3. serve the full-width ``lidar_radar`` predict path (grid 256 x 2048,
     8-feature points, bf16, seeded random weights): distinct B=1 requests,
     one B=4 batch and a p50/p90/p99 latency run, with every kernel's launch
     count reset before and read after; the device ops of one request;
  4. check what came out: finite boxes of the expected shapes, pred maps
     equal to the same model run through the plain versions (bf16
     tolerance), and the fp32 tiny config on the card against the port's
     CPU path (TF32 off; boxes to 1e-3, scores to 1e-4);
  5. train the full-width ``lidar_radar`` model at B=4 (bf16 compute over
     float32 masters) on one fixed fake batch: warm-up, timed steps and one
     eval step, with every kernel's launch count reset before and read
     after; finite losses; the device ops of one step; one step's gradients
     through the kernels against the same step through the plain versions;
  6. the fp32 tiny config's train step on the card against the port's CPU
     step (TF32 off): loss, updated parameters, BN statistics;
  7. the camera kernels K4-K7 against their plain versions at the
     ``lidar_cam_radar`` serving path's shapes, timed as in phase 2 (K4,
     the fused K5 and K6 at the B=1 and the B=4 request, K6 bit for bit
     and also on a precomputed [4, 44, 80] grid, K4 with the atomic adds a
     launch counts on the card before and after merging runs of bins, K5
     with the corners it reads beyond its halo and against ``F.grid_sample``
     plus ``torch.bmm``; the K5 columns kernel, off the serving path; K7 as
     the path calls it, ``bda_bev_warp`` from the BDA matrix to the warped
     map, and against ``F.grid_sample``; the yardsticks are timed and used
     nowhere in the port);
  8. serve the full-width ``lidar_cam_radar`` predict path (ResNet-50 over
     4 cameras of 704 x 1280, DepthNet with the deformable conv, 409 depth
     bins, the LiDAR depth oracle, the BEV warp and fusion; bf16, seeded
     random weights): distinct B=1 requests, one B=4 batch, p50/p90 latency
     at B=1 and B=4 and peak memory (also of one B=4 request alone), with
     every kernel's launch count reset before and read after (the fused K5,
     no column kernel and no ``torch.bmm``; K4, not K8); the fused BEV must
     be bf16; the share of corners the fused K5 reads beyond its halo on
     the path's own offsets; the device ops of one B=1 request;
  9. pred maps of one camera request through the kernels against the plain
     versions (bf16), with a rotated, flipped and scaled BEV augmentation
     and with ``use_depth_loss=False`` (the DCN's depth reaches the splat);
     the fp32 tiny camera config on the card against the port's CPU path
     (TF32 off; boxes to 1e-3, scores to 1e-4);
 10. the backward kernels K4', K5' (the DCN's whole backward: d x, d
     offsets, d weight, d bias) and K7' against their plain versions
     (autograd through the plain forward) at the camera train path's shapes,
     B=1 and B=4, bf16 and float32, K5' also at whole pixels
     (``exps/backward_checks.py``; K4', K7' and K5''s fixed-order outputs
     the same bits on a second call), timed as in phase 2 beside their
     bounds and the library calls of the routes they replaced: for K7'
     ``aten.grid_sampler_2d_backward``, for K5' that call plus the ten
     ``torch.bmm`` of the grouped products on the columns;
 11. train the full-width ``lidar_cam_radar`` model at B=4 (bf16 compute
     over float32 masters, a rotated BEV augmentation, the step's own random
     flips and dropout): 2 warm-up steps, 10 timed steps (p50, p90,
     samples/s, peak memory), the losses finite, one eval step, every
     kernel's launch count reset before and read after (each kernel of the
     path, the three backward kernels among them, launched; the columns
     kernel, K8 and K8' not); the device ops of one step, counted in a
     process of its own;
 12. one full-width camera step at B=1 (random DCN offsets, a rotated BEV
     augmentation, one image flipped) through the kernels against the plain
     versions in float32, with the depth oracle and without: gradients and
     loss within 1/32 (L2), the plain path's own run-to-run difference
     beside it;
 13. the fp32 tiny camera config's train step on the card against the
     port's CPU step with the same random draws: loss, update, BN statistics;
 14. the raw-rig splat K8 and its backward K8' against their plain versions
     at the raw-rig path's B=1 and B=4 shapes on the pitched fake rig's own
     indices, bf16 and float32, depth channels-last and NCHW (1e-5 of each
     entry's sum of |terms|, one bf16 ulp more in bf16; K8' the same bits
     on a second call), timed as in phase 2 beside their bounds and plain
     times; K8 with the counts one launch keeps on the card (each kept row
     scattered once, its integer atomics), no float atomic in its SASS
     (``cuobjdump -sass``; K4's, read the same way, has some) and the
     rig's interval statistics (entries a cell);
 15. serve the raw-rig ``lidar_cam_radar`` (``factorized_splat=False``,
     every camera pitched by 3 degrees) as phase 8 serves the factorized
     one: distinct B=1 requests, one B=4 batch, p50/p90 at B=1 and B=4;
     K8 launched and K4 not;
 16. its pred maps through the kernels against the plain versions (bf16),
     as phase 9; the tiny fp32 raw-rig camera configs on the card against
     the port's CPU path;
 17. train the raw-rig model at B=4 as phase 11: 2 warm-up steps, 5 timed
     steps, one eval step; K8 and K8' launched once a step, K4 and K4'
     never; the device ops of one step in a process of its own;
 18. one full-width raw-rig camera step at B=1 through the kernels against
     the plain versions in float32, with the depth oracle and without, as
     phase 12;
 19. the fp32 tiny raw-rig camera config's train step on the card against
     the port's CPU step;
 20. write an aiMotive tree with the port's writer (LAZ frames of ~100k
     points and 704 x 1280 front and back JPEGs of the writer's
     ``image_detail``, encoded by the port's own encoder; train 16 frames,
     val 8) and time the port's loader alone for ``lidar_radar``
     (samples/s at B=4, 8 thread workers; no image decoded);
 21. in a process of its own, train full-width ``lidar_radar`` through
     ``exps.train`` (B=4, 12 steps: a sanity val, a 'latest' every 4 steps,
     a val each 4-step epoch, the test pass on 'best'), every kernel's launch
     count reset before and read after (A, A', K1, K2 and K3 launched, no
     plain version called), the step p50 (the trainer's StepTimer) and the
     device's busy share of one more, profiled, epoch;
 22. ``exps.evaluate`` on 'best' (``eval_lidar_radar``, ``eval_split=None``)
     reproduces the val_detection_loss recorded for that step within 1e-4
     relative and writes one aiMotive JSON a val frame, parsed back to boxes;
 23. cv2, PIL, jax and mm_training_tpu are not imported by these phases;
 24. the camera data path's loader alone, as phase 20 times it: for
     ``lidar_cam_radar`` on the same tree (2 cameras, each JPEG decoded by
     the port, re-rendered to a virtual pinhole and augmented), and with
     the fisheyes virtualized (6 cameras) on a second tree of 8 train
     frames with the two fisheyes;
 25. in a process of its own, train full-width ``lidar_cam_radar`` through
     ``exps.train`` as phase 21 trains ``lidar_radar`` (B=4, bf16, ResNet-50
     over the tree's two 704 x 1280 cameras, 12 steps, sanity val, 3 vals,
     the test pass on 'best'): A, A', K1, K2, K3, K4, K4', K5, K5', K6
     (``depth_labels``), K7 and K7' launched, the columns kernel, K8, K8'
     and K6's ``depth_grid_to_onehot`` not, no plain version called; the
     step p50 and the busy share of one profiled epoch;
 26. ``exps.evaluate`` on its 'best' reproduces the recorded val loss within
     1e-4 relative and writes one aiMotive JSON a val frame;
 27. 2 steps of ``exps.train`` with ``depth_gt_root`` on grids written here
     (the min depth of each frame's own points in each camera's cells,
     ``ops/depth_labels.py::min_depth_grid_plain``): K6's
     ``depth_grid_to_onehot`` launched, its projection ``depth_labels`` not;
 28. cv2, PIL, jax and mm_training_tpu are not imported by these phases;
 29. TTA serving (``use_tta``, the 4-way flip ensemble) of full-width
     ``lidar_radar`` and ``lidar_cam_radar`` at B=1: the launches of one
     request (K1, K4, K5, K7 four times, K6 and K3 once, A four times the
     plain request's), no plain version called, the ensembled pred maps
     through the kernels against the plain versions, TTA and plain p50 in
     alternating rounds (60 and 30 samples each) and each request's peak
     memory;
 30. folded serving (``models/bn_fold.py::fold_model``) of the same models:
     A launched at every folded tail with a unit scale, no plain version
     called, pred maps against the unfolded model's and the boxes kept with
     the same label and a score within 2e-3, folded and unfolded p50 in
     alternating rounds; the fp32 tiny configs folded on the card against
     the port's CPU folded path;
 31. ``use_ema`` training of full-width ``lidar_cam_radar`` at B=4: 2 warm-up
     and 5 timed steps in turns with as many steps without the EMA update,
     both p50s and peak memories, the EMA update's device ms, the shadow of
     the last two EMA steps equal to a host ``ema_update`` of the stored
     masters;
 32. in a process of its own, on the phase-20 tree: ``exps.train`` on
     ``lidar_cam_radar`` with ``use_ema``, ``use_tta`` and
     ``viz_every_n_steps=2`` (4 steps, a val pass, the test pass on 'best'):
     the path's kernels launched, the eval kernels four times an eval batch,
     no plain version called, the BEV, heatmap, depth and cam0 PNGs (IHDR
     size, IDAT rows) and the .ply written; ``exps.train --profile``: a
     trace.json with the kernels of A, A', K1, K4 and K5 (up to three
     sessions); ``exps.inference`` on 'best' with and without ``--fold-bn``
     (fp32, EMA weights): one JSON a val frame, the folded boxes the
     unfolded ones by label and score within 2e-3; ``exps.evaluate`` on
     'best' (EMA, TTA) within 1e-4 of the recorded val loss;
 33. cv2, PIL, jax and mm_training_tpu are not imported by phases 29-32;
 34. (run after phase 6) K1's sparse-input mode (``sparse_encoder_input``:
     the first-K cap inside the kernel) at B=1 and B=4 on LiDAR-like frames
     of 100k points (``exps/kernel_inputs.py::lidar_like_points``, pillars
     of up to ~450 points), on the fake batch's uniform ones and on
     LiDAR-like ones with 20,000 points in one pillar (the input-order
     rank's quadratic worst case, timed too), and kernel
     A's and A''s masked forms at the sparse encoder's largest tail [4, 16,
     256, 2048] bf16 with the B=4 frames' occupancy: the cap's kept set and
     the occupancy bit for bit, the means within one bf16 ulp plus K1's
     atomic-order slack, masked A and A''s dx, d residual bit for bit, its
     per-channel sums to fp32 order; each timed beside its bound and its
     plain version; the device ops of one call of each (phase 1);
 35. serve ``lidar_radar`` with ``LidarEncoderConf.variant='sparse_import'``
     at B=1 and B=4 on LiDAR-like requests: the launches of one request (K1's
     sparse mode once, masked A at each of the encoder's 21 tails, A at each
     head tail, K3 once, the dense entry of K1 never, no plain version
     called), sparse and dense p50 in alternating rounds in one process, a
     B=4 request's peak memory, the device ops of one request; pred maps
     through the kernels against the plain versions (bf16, 1/32); the tiny
     fp32 sparse config on the card against the port's CPU path;
 36. train it at B=4: 2 warm-up and 5 timed steps (p50, samples/s, peak
     memory), one eval step, the launches (masked A' at each encoder tail a
     step), one step's gradients through the kernels against the plain
     versions (1/32, L2, in float32 with TF32 off; the bf16 comparison and
     the plain path's own run-to-run difference printed beside it), every
     masked BN's batch statistics on the card against float64 (1e-5), the
     tiny fp32 sparse train step against the CPU;
 37. in a process of its own, the import loop on a seeded full-width
     ``sparse_import`` ``lidar_cam_radar`` exported to a reference-format
     ``{'state_dict': {'model.…'}}`` checkpoint: ``scripts.import_checkpoint``
     on it (zero unrecognized and skipped LiDAR keys, its smoke predict on
     the card), the written state equal bit for bit to the source, fp32
     boxes of the imported model those of the source (scores 1e-4, centres
     1e-3 m), the folded model (the sparse encoder's 21 BNs unfolded) within
     2e-3, and ``exps.parity`` on the phase-20 tree (one variant, one ODD, 2
     batches) writing both reports; cv2, PIL, jax and mm_training_tpu not
     imported.
Each path's device-op count is printed beside the count before the
one-launch K6 and K2 (the tree they replaced).
The last lines are the kernels JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result. It imports nothing of JAX or of the JAX package.
"""
import contextlib
import copy
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from mm_training_tpu_torch.exps.timing import BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S

SEED = 0
# device ops of one call of each path before the one-launch K6 and K2, on
# the tree they replaced (torch.profiler; exps/profile_predict.py and
# exps/profile_train.py, PERF.md section 5)
BEFORE_DEVICE_OPS = {'lidar_radar B=1 request': 504, 'lidar_radar B=4 train step': 4219,
                     'lidar_cam_radar B=1 request': 917}
# GiB one B=4 lidar_cam_radar request holds at its peak above what is held
# between requests, on the tree before the fused K5 and K1 (exps/ab_kernels.py,
# same process as this tree's; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
# section 5)
BEFORE_CAMERA_B4_ABOVE_GIB = 1.8437
SM_CLOCK_HZ = 1.98e9        # H100 SXM boost clock (data sheet)
INT_LATENCY_CYCLES = 4      # one dependent integer operation on an SM (assumed)


def _swaps():
    """(module, wrapper name, plain version) of every kernel of the port."""
    from mm_training_tpu_torch.ops import (affine_act, circle_nms, deform_conv, depth_labels,
                                           gaussian, voxel_pooling, voxelize, warp)
    return ((affine_act, 'affine_act', affine_act.affine_act_plain),
            (affine_act, 'affine_act_backward', affine_act.affine_act_backward_plain),
            (affine_act, 'affine_act_masked', affine_act.affine_act_masked_plain),
            (affine_act, 'affine_act_masked_backward',
             affine_act.affine_act_masked_backward_plain),
            (voxelize, 'sparse_encoder_input', voxelize.sparse_encoder_input_plain),
            (voxelize, 'voxelize_pillars_dense', voxelize.voxelize_pillars_dense_plain),
            (voxelize, 'pillar_encoder_input', voxelize.pillar_encoder_input_plain),
            (gaussian, 'draw_heatmap', gaussian.draw_heatmap_plain),
            (circle_nms, 'circle_nms_mask', circle_nms.circle_nms_mask_plain),
            (voxel_pooling, 'lift_splat_factorized',
             voxel_pooling.lift_splat_factorized_plain),
            (voxel_pooling, 'lift_splat', voxel_pooling.lift_splat_plain),
            (deform_conv, 'deform_sample', deform_conv.deform_sample_plain),
            (deform_conv, 'deform_conv3x3', deform_conv.deform_conv3x3_plain),
            (depth_labels, 'depth_labels', depth_labels.depth_labels_plain),
            (depth_labels, 'depth_grid_to_onehot', depth_labels.depth_grid_to_onehot_plain),
            (warp, 'warp_affine_nhwc', warp.warp_affine_nhwc_plain),
            (warp, 'bda_bev_warp', warp.bda_bev_warp_plain),
            (voxel_pooling, 'lift_splat_factorized_backward',
             voxel_pooling.lift_splat_factorized_backward_plain),
            (deform_conv, 'deform_conv3x3_backward', deform_conv.deform_conv3x3_backward_plain),
            (warp, 'warp_backward', warp.warp_backward_plain),
            (voxel_pooling, 'lift_splat_backward', voxel_pooling.lift_splat_backward_plain))


def _wrappers():
    """Every kernel wrapper of the port, by row name."""
    return {name: getattr(mod, name) for mod, name, _ in _swaps()}


@contextlib.contextmanager
def _plain_versions():
    """Every kernel wrapper swapped for its plain version."""
    swaps = _swaps()
    with contextlib.ExitStack() as stack:
        for mod, name, plain in swaps:
            stack.enter_context(mock.patch.object(mod, name, plain))
        yield


def _randomize_offsets(model, gen):
    """A random offset conv in every deformable conv (the JAX init is zero,
    which samples the taps at whole pixels): offsets of about 1-2 px, so
    kernel K5 interpolates."""
    from mm_training_tpu_torch.models.depth_net import DeformConv2d
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DeformConv2d):
                w = m.conv_offset.weight
                w.copy_(torch.randn(w.shape, generator=gen).to(w.device)
                        / (w.shape[1] * 9) ** 0.5)


def _randomize_bn(model, gen):
    """Random BN affine and running statistics, so kernel A applies real
    per-channel scales (a fresh BN is the identity)."""
    from mm_training_tpu_torch.models.bn_fold import BatchNorm2d
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                c = m.num_features
                m.weight.copy_(1 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.2 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.5 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))


def _points(cfg, batch_size, seed):
    """(points, mask) of a fake ``cfg`` batch on the card."""
    from mm_training_tpu_torch.data import make_fake_batch
    batch = make_fake_batch(cfg, batch_size=batch_size, seed=seed)
    return (torch.as_tensor(batch['points'], device='cuda'),
            torch.as_tensor(batch['point_mask'], device='cuda'))


def _encoder_channels(cfg):
    """The channels K1 writes for the LiDAR encoder's first conv."""
    from mm_training_tpu_torch.models import LidarBEVEncoder
    with torch.device('meta'):
        enc = LidarBEVEncoder(cfg.get_lidar_conf(), cfg.point_cloud_range, cfg.voxel_size,
                              cfg.out_shape)
    return enc.input_channels


def _path_device_ops(label, fn):
    """Print and return the device operations of one call of a path,
    beside the count before the one-launch K6 and K2
    (``BEFORE_DEVICE_OPS``, where the path had one)."""
    from mm_training_tpu_torch.exps.timing import device_ops
    n = sum(device_ops(fn).values())
    print(f'device ops of one {label}: {n} (before the one-launch K6 and K2: '
          f'{BEFORE_DEVICE_OPS.get(label, "no such path")})', flush=True)
    return n


def count_device_ops(cfg, cam_cfg):
    """Phase 1b: the device operations of one call of each redesigned
    kernel as the paths make it, in torch.profiler sessions before any
    other work of the process (a session that records no device operation
    is taken again, see ``device_ops``): K3 (4 x 500 NMS rows with the
    per-task thresholds by value), K7 (the [1, 32, 256, 80] bf16 camera BEV
    and a BDA matrix), A' ([4, 64, 64, 512] bf16 with a residual), K4 (the
    B=1 camera request), the fused K5 (the B=1 request's DCN, [4, 44, 80,
    512] bf16), K1's encoder input (a B=1 lidar request), K6 (the B=1
    camera request's points and rig, and a precomputed [4, 44, 80] grid)
    and K2 (the B=4 train batch's targets) in one session; A' at
    ResNet-50's [4, 2048, 22, 40], K4, K5, K1 and K6 at the B=4 requests in
    a second. Each kernel is known by its name; any other device op (a
    copy, a fill) counts against every call of its session. Returns
    {kernel row name: device ops a call}."""
    from mm_training_tpu_torch.data import make_fake_batch, random_bda_matrices
    from mm_training_tpu_torch.exps.kernel_inputs import (deform_inputs, deform_shape,
                                                          depth_label_inputs, raw_splat_inputs,
                                                          splat_inputs)
    from mm_training_tpu_torch.exps.timing import device_ops
    from mm_training_tpu_torch.models.centerpoint_head import heatmap_inputs
    from mm_training_tpu_torch.ops import (affine_act, circle_nms, deform_conv, depth_labels,
                                           gaussian, voxel_pooling, voxelize, warp)

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    head, bb = cfg.get_head_conf(), cam_cfg.get_backbone_conf()
    r, k = len(head.tasks), head.bbox_coder.max_num
    centers = torch.rand(r, k, 2, generator=gen, device=dev) * 50
    scores = torch.rand(r, k, generator=gen, device=dev)
    valid = torch.rand(r, k, generator=gen, device=dev) < 0.9
    thresh = tuple(head.test_cfg.min_radius[:r])
    bev = torch.randn(1, *bb.bev_hw, bb.output_channels, generator=gen, device=dev).bfloat16()
    bda = torch.as_tensor(random_bda_matrices(1, SEED + 15), device=dev)

    def bn_case(*shape):
        t = [torch.randn(*shape, generator=gen, device=dev).bfloat16().contiguous(
            memory_format=torch.channels_last) for _ in range(3)]
        return (*t, torch.randn(shape[1], generator=gen, device=dev),
                torch.randn(shape[1], generator=gen, device=dev))
    bn, bn50 = bn_case(4, 64, 64, 512), bn_case(4, 2048, 22, 40)
    splat1 = splat_inputs(cam_cfg, gen, seed=SEED + 8)
    splat4 = splat_inputs(cam_cfg.replace(batch_size=4), gen, seed=SEED + 8)

    def backward(g, x, r, s, t):
        return affine_act.affine_act_backward(g, x, s, t, r, True)
    kernels = {'circle_nms_mask': 'circle_nms', 'bda_bev_warp': 'bev_warp',
               'affine_act_backward': 'affine_act_bwd', 'lift_splat_factorized': 'splat',
               'deform_conv3x3': 'deform_conv_kernel', 'pillar_encoder_input': 'pillar_kernel',
               'depth_labels': 'depth_labels_kernel', 'depth_grid_to_onehot': 'depth_onehot',
               'draw_heatmap': 'heatmap_kernel'}
    dcn1 = deform_inputs(deform_shape(cam_cfg), 4, gen)
    dcn4 = deform_inputs(deform_shape(cam_cfg.replace(batch_size=4)), 4, gen)
    pts1, pts4 = (_points(cfg, b, SEED) for b in (1, 4))
    geo = (cfg.point_cloud_range, cfg.voxel_size, cfg.out_shape)
    channels = _encoder_channels(cfg)

    def encoder_input(pts, mask):
        return voxelize.pillar_encoder_input(pts, mask, *geo, dtype=torch.bfloat16,
                                             channels=channels)
    labels1 = depth_label_inputs(cam_cfg, dev, seed=SEED + 8)
    labels4 = depth_label_inputs(cam_cfg.replace(batch_size=4), dev, seed=SEED + 8)
    grid = torch.rand(4, *bb.feat_hw, generator=gen, device=dev) * 220
    cfg4 = cfg.replace(batch_size=4)
    tb = make_fake_batch(cfg4, seed=SEED)
    heat = heatmap_inputs(cfg4.get_head_conf(), torch.as_tensor(tb['gt_boxes'], device=dev),
                          torch.as_tensor(tb['gt_labels'], device=dev).long(),
                          torch.as_tensor(tb['gt_mask'], device=dev))
    per_call = {}
    for rows, fn in (
            (('circle_nms_mask', 'bda_bev_warp', 'affine_act_backward_residual',
              'lift_splat_factorized', 'deform_conv3x3', 'pillar_encoder_input',
              'depth_labels', 'depth_grid_to_onehot', 'draw_heatmap'),
             lambda: (circle_nms.circle_nms_mask(centers, scores, valid, thresh),
                      warp.bda_bev_warp(bev, bda), backward(*bn),
                      voxel_pooling.lift_splat_factorized(*splat1),
                      deform_conv.deform_conv3x3(*dcn1, 4), encoder_input(*pts1),
                      depth_labels.depth_labels(*labels1),
                      depth_labels.depth_grid_to_onehot(grid, bb.d_bound, bb.depth_channels),
                      gaussian.draw_heatmap(*heat))),
            (('affine_act_backward_resnet50', 'lift_splat_factorized_b4', 'deform_conv3x3_b4',
              'pillar_encoder_input_b4', 'depth_labels_b4'),
             lambda: (backward(*bn50), voxel_pooling.lift_splat_factorized(*splat4),
                      deform_conv.deform_conv3x3(*dcn4, 4), encoder_input(*pts4),
                      depth_labels.depth_labels(*labels4)))):
        ops = device_ops(fn)
        print(f'device ops of one call each of {list(rows)} (torch.profiler): '
              f'{json.dumps(ops)}', flush=True)
        keys = {row: next(v for w, v in kernels.items() if row.startswith(w)) for row in rows}
        other = sum(n for name, n in ops.items() if not any(v in name for v in keys.values()))
        for row, key in keys.items():
            per_call[row] = other + sum(n for name, n in ops.items() if key in name)
    # the backward kernels and the raw-rig splat, each in a session of its
    # own: K4', K7' (the gather: no fill, no rounding kernel), K8 and K8' one
    # kernel; K5' two (d x and d offsets, then d weight and d bias), three at
    # most. Counted here, before any backward runs: after the kernels have
    # launched from autograd's device thread, later sessions of a process
    # have come back empty (PERF.md section 7)
    bwd_limits = {'lift_splat_factorized_backward': 1, 'warp_backward': 1,
                  'deform_conv3x3_backward': 3, 'lift_splat': 1, 'lift_splat_backward': 1}
    bwd_names = {'lift_splat_factorized_backward': 'lift_splat_bwd',
                 'warp_backward': 'bev_warp_bwd', 'deform_conv3x3_backward': 'deform_bwd',
                 'lift_splat': 'lift_splat_raw_kernel', 'lift_splat_backward': 'lift_splat_raw_bwd'}
    for bsz, s1, sp, dcn in ((1, '', splat1, dcn1), (4, '_b4', splat4, dcn4)):
        raw = raw_splat_inputs(cam_cfg.replace(batch_size=bsz), gen, seed=SEED + 8)
        graw = torch.randn(raw[2].shape[0], raw[3], bb.output_channels, generator=gen,
                           device=dev).bfloat16()
        gsp = torch.randn(sp[2].shape[0], sp[4], bb.output_channels, generator=gen,
                          device=dev).bfloat16()
        img = torch.randn(bsz, *bb.bev_hw, bb.output_channels, generator=gen, device=dev).bfloat16()
        bdab = torch.as_tensor(random_bda_matrices(bsz, SEED + 15), device=dev)
        x, off, wgt, bias = dcn
        dy = torch.randn(*x.shape[:3], wgt.shape[0] * wgt.shape[2], generator=gen,
                         device=dev).bfloat16()
        for name, fn in (
                ('lift_splat_factorized_backward',
                 lambda sp=sp, gsp=gsp: voxel_pooling.lift_splat_factorized_backward(gsp, *sp)),
                ('warp_backward', lambda img=img, bdab=bdab: warp.warp_backward(img, img, bdab, 4)),
                ('deform_conv3x3_backward',
                 lambda dcn=dcn, dy=dy: deform_conv.deform_conv3x3_backward(dy, *dcn, 4)),
                ('lift_splat', lambda raw=raw: voxel_pooling.lift_splat(*raw)),
                ('lift_splat_backward',
                 lambda raw=raw, graw=graw: voxel_pooling.lift_splat_backward(graw, *raw))):
            ops = device_ops(fn)
            per_call[name + s1] = sum(ops.values())
            print(f'device ops of one {name}{s1} call (torch.profiler): {json.dumps(ops)}',
                  flush=True)
            if (per_call[name + s1] > bwd_limits[name]
                    or not all(bwd_names[name] in op for op in ops)):
                raise AssertionError(f'{name}{s1}: {ops} a call, more than {bwd_limits[name]} '
                                     f'device ops or one not named {bwd_names[name]}')
    del gsp, img, dy, raw, graw
    # phase 34's kernels: K1's sparse mode on a LiDAR-like B=1 frame, masked
    # A and A' at the sparse encoder's largest tail, in a session of their own
    from mm_training_tpu_torch.exps.kernel_inputs import lidar_like_points
    sp_pts = lidar_like_points(cfg, 1, SEED + 71)
    cap = cfg.get_lidar_conf().voxelization.max_num_points
    sp_channels = _sparse_channels(cfg)
    mx, mr, mg, ms, mt = bn_case(4, 16, 256, 2048)
    mk = (torch.rand(4, 1, 256, 2048, generator=gen, device=dev) < 0.2).contiguous()
    sparse_names = {'sparse_encoder_input': 'sparse_kernel', 'affine_act_masked':
                    'affine_act_kernel', 'affine_act_masked_backward': 'affine_act_bwd'}
    ops = device_ops(lambda: (
        voxelize.sparse_encoder_input(*sp_pts, *geo, dtype=torch.bfloat16, channels=sp_channels,
                                      max_points_per_voxel=cap),
        affine_act.affine_act_masked(mx, ms, mt, mk, mr),
        affine_act.affine_act_masked_backward(mg, mx, ms, mt, mk, mr)))
    print(f'device ops of one call each of {list(sparse_names)} (torch.profiler): '
          f'{json.dumps(ops)}', flush=True)
    other = sum(n for name, n in ops.items()
                if not any(v in name for v in sparse_names.values()))
    for row, key in sparse_names.items():
        per_call[row] = other + sum(n for name, n in ops.items() if key in name)
    del mx, mr, mg, mk
    one = ('circle_nms_mask', 'bda_bev_warp', 'affine_act_backward_residual',
           'affine_act_backward_resnet50', 'deform_conv3x3', 'deform_conv3x3_b4',
           'pillar_encoder_input', 'pillar_encoder_input_b4', 'depth_labels',
           'depth_labels_b4', 'depth_grid_to_onehot', 'draw_heatmap',
           'sparse_encoder_input', 'affine_act_masked', 'affine_act_masked_backward')
    if any(per_call[n] != 1 for n in one) or not all(
            1 <= per_call[n] <= 2 for n in ('lift_splat_factorized', 'lift_splat_factorized_b4')):
        raise AssertionError(f"K1's encoder input and sparse mode, K2, K3, K5, K6, K7, A' and "
                             f"masked A and A' must each be one device kernel a call, K4 at "
                             f'most two: {per_call}')
    return per_call


def check_kernels(cfg):
    """Phase 2: each kernel against its plain version at the paths' shapes."""
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.exps.profile_nms import nms_rows
    from mm_training_tpu_torch.exps.timing import device_ms, host_ms
    from mm_training_tpu_torch.models.centerpoint_head import heatmap_inputs
    from mm_training_tpu_torch.ops import affine_act, circle_nms, gaussian, voxelize

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    # --- kernel A at the head's dominant BN shape (B=1: 64 x 512 x 64 ch,
    # the neck deblocks, shared conv and 24 SeparateHead branches), plus the
    # residual and no-ReLU forms at the trunk's BasicBlock shape
    def cl(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x = cl(1, 64, 64, 512)
    s, t = torch.randn(64, generator=gen, device=dev), torch.randn(64, generator=gen, device=dev)
    err = (affine_act.affine_act(x, s, t).float()
           - affine_act.affine_act_plain(x, s, t).float()).abs().max().item()
    xr, rr = cl(1, 320, 4, 32), cl(1, 320, 4, 32)
    sr, tr = torch.randn(320, generator=gen, device=dev), torch.randn(320, generator=gen, device=dev)
    for res, relu in ((rr, True), (None, False), (rr, False)):
        d = (affine_act.affine_act(xr, sr, tr, res, relu).float()
             - affine_act.affine_act_plain(xr, sr, tr, res, relu).float())
        err = max(err, d.abs().max().item())
    nbytes = 2 * x.numel() * x.element_size()
    rows.append(dict(
        name='affine_act', route='cuda', source='mm_training_tpu_torch/csrc/affine_act.cu',
        replaces='scripts/bn_elementwise_probe.py:88', max_abs_err=err,
        ms=device_ms(lambda: affine_act.affine_act(x, s, t), 200),
        call_ms=host_ms(lambda: affine_act.affine_act(x, s, t), 200),
        plain_ms=device_ms(lambda: affine_act.affine_act_plain(x, s, t), 50),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by='bytes', library_ms=None,
        shape=list(x.shape), dtype='bfloat16'))

    # --- K1 on a B=1 request of the path (100k points, full grid)
    batch = make_fake_batch(cfg, batch_size=1, seed=SEED)
    pts = torch.as_tensor(batch['points'], device=dev)
    mask = torch.as_tensor(batch['point_mask'], device=dev)
    geo = (cfg.point_cloud_range, cfg.voxel_size, cfg.out_shape)
    nf = cfg.get_lidar_conf().voxelization.num_features
    got = voxelize.voxelize_pillars_dense(pts, mask, *geo, num_features=nf)
    want = voxelize.voxelize_pillars_dense_plain(pts, mask, *geo, num_features=nf)
    seg = voxelize.pillar_segments(pts, mask, *geo)[0]
    feats = pts[0, :, :nf].contiguous()
    index = seg[:, None].expand(-1, nf)
    n_cells = cfg.out_shape[0] * cfg.out_shape[1]

    def library():   # one PyTorch call computing the per-pillar mean
        return torch.zeros(n_cells + 1, nf, device=dev).scatter_reduce_(
            0, index, feats, 'mean', include_self=False)
    lib_err = (library()[:n_cells].view_as(want[0]) - want[0]).abs().max().item()
    # the mask, the nf averaged features of each masked-in point, the grid out
    nbytes = mask.numel() + int(mask.sum()) * nf * 4 + got.numel() * 4
    rows.append(dict(
        name='voxelize_pillars_dense', route='cuda',
        source='mm_training_tpu_torch/csrc/voxelize.cu',
        replaces='mm_training_tpu/ops/voxelize.py:27',
        max_abs_err=(got - want).abs().max().item(),
        ms=device_ms(lambda: voxelize.voxelize_pillars_dense(pts, mask, *geo, num_features=nf), 100),
        call_ms=host_ms(lambda: voxelize.voxelize_pillars_dense(pts, mask, *geo,
                                                                 num_features=nf), 100),
        plain_ms=device_ms(lambda: voxelize.voxelize_pillars_dense_plain(pts, mask, *geo, num_features=nf), 20),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by='bytes',
        library_ms=device_ms(library, 20), library_max_abs_err=lib_err,
        shape=list(pts.shape), dtype='float32'))

    # --- K1 into the encoder's input, as the lidar encoder asks for it (bf16,
    # space-to-depth, zero channels up to its first conv's padded input), at
    # a B=1 request and at the train step's B=4 batch
    channels = _encoder_channels(cfg)
    for name, bsz in (('pillar_encoder_input', 1), ('pillar_encoder_input_b4', 4)):
        pts, mask = _points(cfg, bsz, SEED)
        enc_args = (pts, mask, *geo, nf, torch.bfloat16, True, channels)
        got = voxelize.pillar_encoder_input(*enc_args)
        want = voxelize.pillar_encoder_input_plain(*enc_args)
        w = want.float()
        ulp = torch.where(w == 0, 0.0, torch.exp2(torch.floor(torch.log2(w.abs())) - 7))
        diff = (got.float() - w).abs()
        nbytes = mask.numel() + int(mask.sum()) * nf * 4 + got.numel() * 2
        rows.append(dict(
            name=name, route='cuda', source='mm_training_tpu_torch/csrc/voxelize.cu',
            replaces='mm_training_tpu/ops/voxelize.py:27',
            max_abs_err=diff.max().item(),
            # one bf16 ulp plus the atomic-order slack of the fp32 means
            outside_tolerance=int((diff > ulp + 1e-5 * (1 + w.abs())).sum()),
            pad_zero=bool(torch.equal(got[..., 4 * nf:], torch.zeros_like(got[..., 4 * nf:]))),
            ms=device_ms(lambda: voxelize.pillar_encoder_input(*enc_args), 100),
            call_ms=host_ms(lambda: voxelize.pillar_encoder_input(*enc_args), 100),
            plain_ms=device_ms(lambda: voxelize.pillar_encoder_input_plain(*enc_args), 10),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by='bytes', library_ms=None,
            shape=list(pts.shape), out_shape=list(got.shape), dtype='bfloat16'))

    # --- K3 on one request's (batch, task) rows: 4 x K=500 candidates, the
    # per-task thresholds by value as the decode passes them
    head = cfg.get_head_conf()
    r, k = len(head.tasks), head.bbox_coder.max_num
    pc = cfg.point_cloud_range
    lo = torch.tensor(pc[:2], device=dev)
    hi = torch.tensor(pc[3:5], device=dev)
    centers = lo + torch.rand(r, k, 2, generator=gen, device=dev) * (hi - lo)
    scores = torch.rand(r, k, generator=gen, device=dev)
    valid = torch.rand(r, k, generator=gen, device=dev) < 0.9
    thresh = tuple(head.test_cfg.min_radius[:r])
    keep = circle_nms.circle_nms_mask(centers, scores, valid, thresh)
    keep_plain = circle_nms.circle_nms_mask_plain(centers, scores, valid, thresh)
    keep_rows = circle_nms.circle_nms_mask(centers, scores, valid,
                                           torch.tensor(thresh, device=dev))
    # the dense side: a chain of boxes, each close to its neighbours only,
    # whose diagonal blocks the sweep resolves in its unrolled steps
    dense = nms_rows('chain', k, pc, thresh, gen)
    dense_err = (circle_nms.circle_nms_mask(*dense, thresh).int()
                 - circle_nms.circle_nms_mask_plain(*dense, thresh).int()).abs().max().item()
    nbytes = r * k * (8 + 4 + 1 + 1)
    n_valid = valid.sum(1).long()
    # 2 sub, 2 mul, 1 add for each pair of valid boxes (invalid ones never
    # suppress and are never kept)
    flops = int((n_valid * (n_valid - 1) // 2).sum()) * 5
    rows.append(dict(
        name='circle_nms_mask', route='cuda', source='mm_training_tpu_torch/csrc/circle_nms.cu',
        replaces='mm_training_tpu/ops/circle_nms.py:23',
        max_abs_err=max((keep.int() - keep_plain.int()).abs().max().item(),
                        (keep_rows.int() - keep_plain.int()).abs().max().item(), dense_err),
        ms=device_ms(lambda: circle_nms.circle_nms_mask(centers, scores, valid, thresh), 100),
        call_ms=host_ms(lambda: circle_nms.circle_nms_mask(centers, scores, valid, thresh), 100),
        plain_ms=device_ms(lambda: circle_nms.circle_nms_mask_plain(centers, scores, valid, thresh), 3),
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
        bound_by='operations' if flops / FP32_FLOPS > nbytes / HBM_BYTES_PER_S else 'bytes',
        library_ms=None, kept=int(keep.sum()), shape=[r, k], dtype='float32',
        dense_ms=device_ms(lambda: circle_nms.circle_nms_mask(*dense, thresh), 100)))
    # the greedy sweep: K dependent steps of at least one integer operation,
    # from the two assumed constants above; nothing here measures it
    print(f'K3 sequential floor (computed, not measured: {k} steps x {INT_LATENCY_CYCLES} '
          f'cycles at {SM_CLOCK_HZ / 1e9} GHz): {k * INT_LATENCY_CYCLES / SM_CLOCK_HZ * 1e3} ms',
          flush=True)

    # --- A' at the train path's dominant BN shape (B=4: 64 x 512 x 64 ch),
    # without and with a residual, and at ResNet-50's last stage (2048
    # channels, 22 x 40, 4 cameras) with the Bottleneck's residual
    x4, g4, r4 = cl(4, 64, 64, 512), cl(4, 64, 64, 512), cl(4, 64, 64, 512)
    x50, g50, r50 = cl(4, 2048, 22, 40), cl(4, 2048, 22, 40), cl(4, 2048, 22, 40)
    s50 = torch.randn(2048, generator=gen, device=dev)
    t50 = torch.randn(2048, generator=gen, device=dev)
    for name, (g, x, res, sb, tb) in (
            ('affine_act_backward', (g4, x4, None, s, t)),
            ('affine_act_backward_residual', (g4, x4, r4, s, t)),
            ('affine_act_backward_resnet50', (g50, x50, r50, s50, t50))):
        got = affine_act.affine_act_backward(g, x, sb, tb, res, True)
        want = affine_act.affine_act_backward_plain(g, x, sb, tb, res, True)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got[:2], want[:2]) if a is not None)
        # ds, dt: fp32 sums over N*H*W terms in another order, against the
        # sum of the terms' magnitudes
        m = want[1].float() if res is not None else None
        if m is None:
            z = x.float() * sb.view(1, -1, 1, 1) + tb.view(1, -1, 1, 1)
            m = torch.where(z > 0, g.float(), 0.0)
        mags = ((m * x.float()).abs().sum((0, 2, 3)), m.abs().sum((0, 2, 3)))
        sum_err = max(((a - b).abs() / mag.clamp_min(1e-30)).max().item()
                      for a, b, mag in zip(got[2:], want[2:], mags))
        again = affine_act.affine_act_backward(g, x, sb, tb, res, True)
        deterministic = all(torch.equal(a, b) for a, b in zip(got[2:], again[2:]))
        nbytes = (3 + 2 * (res is not None)) * x.numel() * x.element_size()

        def kernel(g=g, x=x, res=res, sb=sb, tb=tb):
            return affine_act.affine_act_backward(g, x, sb, tb, res, True)

        def plain(g=g, x=x, res=res, sb=sb, tb=tb):
            return affine_act.affine_act_backward_plain(g, x, sb, tb, res, True)
        rows.append(dict(
            name=name, route='cuda', source='mm_training_tpu_torch/csrc/affine_act_backward.cu',
            replaces='scripts/bn_elementwise_probe.py:88', max_abs_err=err,
            sum_rel_err=sum_err, deterministic=deterministic,
            ms=device_ms(kernel, 100), call_ms=host_ms(kernel, 100),
            plain_ms=device_ms(plain, 20),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by='bytes', library_ms=None,
            shape=list(x.shape), dtype='bfloat16'))

    # --- K2 on the train path's targets: a B=4 fake batch (500 object slots)
    cfg4 = cfg.replace(batch_size=4)
    tb = make_fake_batch(cfg4, seed=SEED)
    centers, radii, valid, hw = heatmap_inputs(
        cfg4.get_head_conf(), torch.as_tensor(tb['gt_boxes'], device=dev),
        torch.as_tensor(tb['gt_labels'], device=dev).long(),
        torch.as_tensor(tb['gt_mask'], device=dev))
    got = gaussian.draw_heatmap(centers, radii, valid, hw)
    want = gaussian.draw_heatmap_plain(centers, radii, valid, hw)
    centres_equal = torch.equal(got == 1.0, want == 1.0)
    deterministic = torch.equal(gaussian.draw_heatmap(centers, radii, valid, hw), got)
    # bytes: the maps written, the operands read; operations: ~8 a drawn
    # cell (2 sub, 2 mul, add, div, exp, max) over the clipped windows
    bsz, m_maps, k_obj = valid.shape
    vb, vm, vk = valid.nonzero(as_tuple=True)
    cx, cy, r = centers[vb, vk, 0], centers[vb, vk, 1], radii[vb, vk]
    wx = (torch.clamp(cx + r, max=hw[1] - 1) - torch.clamp(cx - r, min=0) + 1).clamp_min(0)
    wy = (torch.clamp(cy + r, max=hw[0] - 1) - torch.clamp(cy - r, min=0) + 1).clamp_min(0)
    cells = int((wx * wy).sum())
    nbytes = got.numel() * 4 + centers.numel() * 4 + radii.numel() * 4 + valid.numel()
    flops = cells * 8
    rows.append(dict(
        name='draw_heatmap', route='cuda', source='mm_training_tpu_torch/csrc/gaussian_heatmap.cu',
        replaces='mm_training_tpu/ops/gaussian.py:45',
        max_abs_err=(got - want).abs().max().item(), centres_equal=centres_equal,
        deterministic=deterministic,
        ms=device_ms(lambda: gaussian.draw_heatmap(centers, radii, valid, hw), 100),
        call_ms=host_ms(lambda: gaussian.draw_heatmap(centers, radii, valid, hw), 100),
        plain_ms=device_ms(lambda: gaussian.draw_heatmap_plain(centers, radii, valid, hw), 10),
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3,
        bound_by='operations' if flops / FP32_FLOPS > nbytes / HBM_BYTES_PER_S else 'bytes',
        library_ms=None, drawn_windows=int(vb.numel()), drawn_cells=cells,
        shape=[bsz, m_maps, k_obj, *hw], dtype='float32'))

    for row in rows:
        print(f"kernel {row['name']}: max_abs_err={row['max_abs_err']} ms={row['ms']:.6f} "
              f"call_ms={row['call_ms']:.6f} plain_ms={row['plain_ms']:.6f} "
              f"bound_ms={row['bound_ms']:.6f} library_ms={row['library_ms']}", flush=True)
    by = {row['name']: row for row in rows}
    if by['affine_act']['max_abs_err'] != 0:       # same fp32 steps, one rounding
        raise AssertionError(f"affine_act differs from its plain version: {by['affine_act']}")
    if not by['voxelize_pillars_dense']['max_abs_err'] <= 1e-4:  # atomics: another order
        raise AssertionError(f"voxelize differs from its plain version: "
                             f"{by['voxelize_pillars_dense']}")
    for name in ('pillar_encoder_input', 'pillar_encoder_input_b4'):
        if by[name]['outside_tolerance'] or not by[name]['pad_zero']:
            raise AssertionError(f'{name} differs from its plain version: {by[name]}')
    if by['circle_nms_mask']['max_abs_err'] != 0:
        raise AssertionError(f"circle_nms differs from its plain version: "
                             f"{by['circle_nms_mask']}")
    for name in ('affine_act_backward', 'affine_act_backward_residual',
                 'affine_act_backward_resnet50'):
        row = by[name]
        # dx, dr bit for bit; ds, dt to 1e-5 of the sum of |terms|; the
        # same bits on a second launch
        if row['max_abs_err'] != 0 or not row['sum_rel_err'] <= 1e-5 \
                or not row['deterministic']:
            raise AssertionError(f'{name} differs from its plain version: {row}')
    row = by['draw_heatmap']
    # expf may differ from torch.exp by an ulp; centres exactly 1.0 in both;
    # the same bits on a second call
    if not (row['centres_equal'] and row['max_abs_err'] <= 1e-6 and row['drawn_windows']
            and row['deterministic']):
        raise AssertionError(f'draw_heatmap differs from its plain version: {row}')
    return rows


def serve(cfg):
    """Phase 3: the full-width predict path through its entry points."""
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.exps.inference import benchmark_latency
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.training import make_predict_step

    gen = torch.Generator().manual_seed(SEED)
    model = BEVDepthLiDAR(cfg, device='cuda', generator=gen)
    _randomize_bn(model, gen)
    predict = make_predict_step(cfg, model)
    requests = [make_fake_batch(cfg, batch_size=1, seed=SEED + i) for i in range(6)]
    big = make_fake_batch(cfg, batch_size=4, seed=SEED + 100)
    wrappers = _wrappers()

    for w in wrappers.values():
        w.launches = 0
    outs, lat = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append([o.cpu() for o in predict(req)])
        lat.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    out_big = [o.cpu() for o in predict(big)]
    lat_big = (time.perf_counter() - t0) * 1e3
    stats = benchmark_latency(predict, requests[0], iters=200)
    stats_b4 = benchmark_latency(predict, big, iters=40)
    counts = {n: w.launches for n, w in wrappers.items()}
    calls = len(requests) + 1 + (stats['samples'] + 1) + (stats_b4['samples'] + 1)

    print(f'serve: {len(requests)} B=1 requests {[round(v, 3) for v in lat]} ms '
          f'(first includes warm-up), B=4 batch {lat_big:.3f} ms', flush=True)
    print('serve latency B=1: ' + json.dumps(stats), flush=True)
    print('serve latency B=4: ' + json.dumps(stats_b4), flush=True)
    print(f'serve: launches over {calls} predict calls {json.dumps(counts)}', flush=True)
    missing = [n for n in ('affine_act', 'pillar_encoder_input', 'circle_nms_mask')
               if counts[n] == 0]
    if missing:
        raise AssertionError(f'kernels never launched on the main path: {missing}')
    if counts['voxelize_pillars_dense']:    # the encoder takes K1's own layout now
        raise AssertionError('the lidar path launched K1 in its plain layout')
    _path_device_ops('lidar_radar B=1 request', lambda: [o.cpu() for o in predict(requests[0])])

    n_out = len(cfg.get_head_conf().tasks) * cfg.get_head_conf().test_cfg.post_max_size
    for o, b in [(o, 1) for o in outs] + [(out_big, 4)]:
        boxes, scores, labels, valid = o
        if boxes.shape != (b, n_out, 9) or scores.shape != (b, n_out):
            raise AssertionError(f'unexpected output shapes {boxes.shape} {scores.shape}')
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
            raise AssertionError('non-finite boxes or scores')
        if not valid.any(1).all():
            raise AssertionError('a request decoded no box')
    return model, requests[0], counts, calls


def compare_plain(model, request):
    """Phase 4a: pred maps through the kernels vs the plain versions (bf16);
    the forward runs A and K1 (K3 is decode's, held in phase 2)."""
    from mm_training_tpu_torch.training import cast_floating

    net = cast_floating(model, torch.bfloat16)
    pts = torch.as_tensor(request['points'], device='cuda')
    mask = torch.as_tensor(request['point_mask'], device='cuda')
    with torch.inference_mode():
        got = net(pts, mask)
        before = {n: w.launches for n, w in _wrappers().items()}
        with _plain_versions():
            want = net(pts, mask)
        if {n: w.launches for n, w in _wrappers().items()} != before:
            raise AssertionError('the plain run launched a kernel')
    worst = 0.0
    for g, w in zip(got, want):
        for name in w:
            gf, wf = g[name].float(), w[name].float()
            # kernel A matches bit for bit; K1's atomics move a voxel mean by
            # fp32 ulps, which can flip a bf16 rounding of the encoder input
            # and travel through ~40 bf16 layers: allow 1/32 of the map's scale
            rel = ((gf - wf).abs().max() / wf.abs().max().clamp_min(1.0)).item()
            worst = max(worst, rel)
    print(f'plain-path pred maps (bf16): worst max|diff| / max|map| = {worst:.6g}', flush=True)
    if not worst <= 1 / 32:
        raise AssertionError(f'kernel and plain pred maps differ: {worst}')
    return worst


def compare_cpu_reference(cfg=None, bda=None, pitch_deg=0.0, fold=False):
    """Phase 4b (and 9b, 16b with a camera config; 30b with ``fold``): the
    fp32 tiny config on the card vs the port's CPU path; ``bda`` replaces
    the batch's identity ``bda_mat``, ``pitch_deg`` pitches the rig's
    cameras, ``fold`` folds both models' conv+BN pairs first."""
    from mm_training_tpu_torch.configs import tiny_test_config
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.training import make_predict_step

    torch.backends.cudnn.allow_tf32 = False        # fp32 comparison: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or tiny_test_config(use_cam=False)
    gen = torch.Generator().manual_seed(SEED + 1)
    cpu_model = BEVDepthLiDAR(cfg, device='cpu', generator=gen)
    _randomize_bn(cpu_model, gen)
    _randomize_offsets(cpu_model, gen)
    gpu_model = copy.deepcopy(cpu_model).to('cuda')
    if fold:
        from mm_training_tpu_torch.models.bn_fold import fold_model
        fold_model(cpu_model)
        fold_model(gpu_model)
    batch = make_fake_batch(cfg, seed=SEED + 2, pitch_deg=pitch_deg)
    if bda is not None:
        batch['bda_mat'] = bda
    gb, gs, gl, gv = (o.cpu().numpy() for o in make_predict_step(cfg, gpu_model)(batch))
    wb, ws, wl, wv = (o.numpy() for o in make_predict_step(cfg, cpu_model)(batch))
    if not (np.array_equal(gv, wv) and np.array_equal(gl[wv], wl[wv])
            and np.abs(gs - ws).max() <= 1e-4):
        raise AssertionError('tiny fp32 predict on the card differs from the CPU path')
    worst = 0.0
    for b, i in zip(*np.nonzero(wv)):   # near-tied scores may trade slots
        same = gv[b] & (gl[b] == wl[b, i]) & (np.abs(gs[b] - ws[b, i]) <= 1e-4)
        worst = max(worst, float(np.abs(gb[b, same] - wb[b, i]).max(-1).min()))
    print(f'tiny fp32 card vs CPU (camera {cfg.use_cam}, depth oracle '
          f'{cfg.use_cam and cfg.use_depth_loss}, raw rig '
          f'{not cfg.get_backbone_conf().factorized_splat}, folded {fold}): {int(wv.sum())} '
          f'kept boxes, worst box err {worst:.3g}', flush=True)
    if not worst <= 1e-3:
        raise AssertionError(f'tiny fp32 boxes differ from the CPU path by {worst}')


def train(cfg):
    """Phase 5: the full-width train path through its entry points (B=4,
    bf16 compute over float32 masters, one fixed fake batch)."""
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.exps.profile_train import benchmark_train
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.training import (create_train_state, make_eval_step,
                                                make_train_step)

    cfg = cfg.replace(batch_size=4)
    model = BEVDepthLiDAR(cfg, device='cuda', generator=torch.Generator().manual_seed(SEED + 3))
    state = create_train_state(cfg, model)
    train_step, eval_step = make_train_step(cfg), make_eval_step(cfg)
    batch = make_fake_batch(cfg, seed=SEED + 4)
    wrappers = _wrappers()

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    for _ in range(2):
        state, metrics = train_step(state, batch)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    stats = benchmark_train(train_step, state, batch, steps=10)
    ev_metrics, (boxes, scores, _, _), _ = eval_step(state, batch)
    torch.cuda.synchronize()
    counts = {n: w.launches for n, w in wrappers.items()}

    print(f'train: 2 warm-up steps {warm_ms:.3f} ms; B=4 step p50 {stats["p50_ms"]:.3f} ms '
          f'p90 {stats["p90_ms"]:.3f} ms, {stats["samples_per_s"]:.3f} samples/s, '
          f'max_memory_allocated {stats["max_memory_allocated_gb"]:.3f} GiB', flush=True)
    print('train: losses ' + json.dumps([round(v, 4) for v in stats['losses']])
          + f'; eval loss {float(ev_metrics["loss"]):.4f}', flush=True)
    print(f'train: launches over 12 train steps and 1 eval step {json.dumps(counts)}',
          flush=True)
    missing = [n for n in ('affine_act', 'affine_act_backward', 'pillar_encoder_input',
                           'draw_heatmap', 'circle_nms_mask') if counts[n] == 0]
    if missing:
        raise AssertionError(f'kernels never launched on the train path: {missing}')
    if counts['voxelize_pillars_dense']:
        raise AssertionError('the train path launched K1 in its plain layout')
    if not all(np.isfinite(stats['losses'])) or not torch.isfinite(ev_metrics['loss']):
        raise AssertionError('non-finite train or eval loss')
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError('non-finite eval boxes')
    if not stats['losses'][-1] < stats['losses'][0]:
        raise AssertionError(f'the train loss did not fall on one batch: {stats["losses"]}')
    box = [state]

    def step():
        box[0], _ = train_step(box[0], batch)
        torch.cuda.synchronize()
    _path_device_ops('lidar_radar B=4 train step', step)
    return cfg, box[0], batch, counts, stats


def compare_plain_gradients(cfg, state, batch):
    """Phase 5b: one step's gradients through the kernels against the same
    step with every kernel swapped for its plain version (float32 masters,
    bf16 compute)."""
    from mm_training_tpu_torch.training import loss_and_grads

    names = [n for n, _ in state.model.named_parameters()]
    buffers = {n: b.clone() for n, b in state.model.named_buffers()}
    loss, got, _ = loss_and_grads(cfg, state, batch)
    state.model.load_state_dict(buffers, strict=False)    # the same BN statistics
    before = {n: w.launches for n, w in _wrappers().items()}
    with _plain_versions():
        loss_p, want, _ = loss_and_grads(cfg, state, batch)
    if {n: w.launches for n, w in _wrappers().items()} != before:
        raise AssertionError('the plain run launched a kernel')
    state.model.load_state_dict(buffers, strict=False)
    def l2(ts):
        return torch.sqrt(sum((t.double() ** 2).sum() for t in ts))
    rel = (l2([a - b for a, b in zip(got, want)]) / l2(want)).item()
    per = sorted(((((a - b).norm() / b.norm().clamp_min(1e-30)).item(), n)
                  for a, b, n in zip(got, want, names)), reverse=True)
    loss_rel = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
    print(f'train gradients kernels vs plain (bf16): loss rel diff {loss_rel:.3g}, '
          f'|g_k - g_p| / |g_p| over all parameters {rel:.4g}; worst tensors '
          + json.dumps([(n, round(v, 5)) for v, n in per[:4]]), flush=True)
    # kernel A and A' agree bit for bit on the elementwise terms; K1's
    # atomics and A''s per-channel sums round in another order, which
    # flips bf16 roundings downstream: allow 1/32 over all parameters
    if not (rel <= 1 / 32 and loss_rel <= 1 / 32):
        raise AssertionError(f'kernel and plain gradients differ: {rel}, loss {loss_rel}')
    return rel


def compare_cpu_train(cfg=None, pitch_deg=0.0):
    """Phase 6 (and 13, 19 with a camera config): the fp32 tiny config's
    train step on the card against the port's CPU step (TF32 off); with the
    camera, random DCN offsets, a rotated BEV augmentation and the same
    random draws (flips, dropout) on both; ``pitch_deg`` pitches the rig's
    cameras."""
    from mm_training_tpu_torch.configs import tiny_test_config
    from mm_training_tpu_torch.data import make_fake_batch, random_bda_matrices
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.training import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False        # fp32 comparison: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or tiny_test_config(use_cam=False)
    gen = torch.Generator().manual_seed(SEED + 5)
    cpu_model = BEVDepthLiDAR(cfg, device='cpu', generator=gen)
    _randomize_bn(cpu_model, gen)
    batch = make_fake_batch(cfg, seed=SEED + 6, pitch_deg=pitch_deg)
    draws = {'cuda': None, 'cpu': None}
    if cfg.use_cam:
        _randomize_offsets(cpu_model, gen)
        batch['bda_mat'] = random_bda_matrices(cfg.batch_size, SEED + 38)
        draws = {d: _camera_draws(cfg, batch['imgs'].shape, SEED + 39, d) for d in draws}
    gpu_model = copy.deepcopy(cpu_model).to('cuda')
    old = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    step = make_train_step(cfg)
    _, gm = step(create_train_state(cfg, gpu_model), batch, draws['cuda'])
    ws, wm = step(create_train_state(cfg, cpu_model), batch, draws['cpu'])
    lr = cfg.learning_rate
    loss_rel = abs(float(gm['train_loss']) - float(wm['train_loss'])) / float(wm['train_loss'])
    worst_all = worst_strong = stats_err = 0.0
    for (n, p_gpu), p_cpu, mu in zip(gpu_model.named_parameters(), cpu_model.parameters(),
                                     ws.optimizer.mu):
        d = ((p_gpu.detach().cpu() - old[n]) - (p_cpu.detach() - old[n])).abs()
        worst_all = max(worst_all, d.max().item())
        # fp32 gradients of a random init are ill-conditioned (BN subtracts a
        # near-constant gradient, so sums in another order move small entries
        # by up to ~10% of a tensor's largest): hold the update to 1e-3 lr
        # only where |g| is a quarter of its tensor's largest or more and
        # 400 x Adam's eps or more, where Adam's step is sign(g) to 1e-3
        g = mu.abs() / 0.1
        strong = (g >= 0.25 * g.max()) & (g >= 400 * 1e-8)
        worst_strong = max(worst_strong, torch.where(strong, d, 0.0).max().item())
    for (n, b_gpu), b_cpu in zip(gpu_model.named_buffers(), cpu_model.buffers()):
        if n.endswith(('running_mean', 'running_var')):
            stats_err = max(stats_err, ((b_gpu.cpu() - b_cpu).abs()
                                        / (1 + b_cpu.abs())).max().item())
    print(f'tiny fp32 train step card vs CPU (camera {cfg.use_cam}, raw rig '
          f'{not cfg.get_backbone_conf().factorized_splat}): loss rel diff '
          f'{loss_rel:.3g}, update diff {worst_all / lr:.4g} lr everywhere, '
          f'{worst_strong / lr:.4g} lr where |g| is strong; BN stats {stats_err:.3g}',
          flush=True)
    # everywhere: two opposite Adam steps of lr (1 + weight decay) at most
    if not (loss_rel <= 1e-5 and worst_all <= 2.001 * lr and worst_strong <= 1e-3 * lr
            and stats_err <= 1e-5):
        raise AssertionError('tiny fp32 train step on the card differs from the CPU step')


def _bound(nbytes, flops, rate):
    """(bound ms, what bounds it): bytes over the memory rate against
    operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, 'operations' if t_ops > t_bytes else 'bytes'


def _warp_grid(minv, h, w):
    """F.grid_sample's normalised grid (align_corners=True: pixel centres)
    of the source points ``minv`` @ (x, y, 1) of every dst pixel, [B, H, W,
    2]: the yardstick of K7 and K7'."""
    dev = minv.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32), indexing='ij')
    q = torch.stack([xs, ys, torch.ones_like(xs)], -1)[None] @ minv.transpose(1, 2)[:, None]
    return torch.stack([q[..., 0] / q[..., 2] / (w - 1), q[..., 1] / q[..., 2] / (h - 1)],
                       -1) * 2 - 1


def _tap_points(off):
    """(y, x) in pixels of the 9 taps of every pixel, each [B, H, W, 9], for
    offsets [B, H, W, 18], in K5's order of operations."""
    bm, hh, ww = off.shape[:3]
    dev = off.device
    ys = torch.arange(hh, device=dev, dtype=torch.float32).view(1, hh, 1, 1)
    xs = torch.arange(ww, device=dev, dtype=torch.float32).view(1, 1, ww, 1)
    k = torch.arange(9, device=dev)
    o5 = off.view(bm, hh, ww, 9, 2)
    return ys + (k // 3 - 1).float() + o5[..., 0], xs + (k % 3 - 1).float() + o5[..., 1]


def _deform_grid(off):
    """F.grid_sample's normalised grid of the 9 taps of every pixel, [B, H,
    W*9, 2], for offsets [B, H, W, 18]: the yardstick of K5 and K5'."""
    bm, hh, ww = off.shape[:3]
    gy, gx = _tap_points(off)
    return torch.stack([gx / (ww - 1), gy / (hh - 1)], -1).view(bm, hh, ww * 9, 2) * 2 - 1


def check_camera_kernels(cfg):
    """Phase 7: K4-K7 against their plain versions at the camera serving
    path's shapes (one B=1 request: 4 cameras, 409 bins, 44 x 80 features,
    an 8192-cell camera BEV; K4, the fused K5 and K6 also at the B=4
    request), K6 on the requests' own points and rig, and its binning on a
    precomputed grid."""
    from mm_training_tpu_torch.data import random_bda_matrices
    from mm_training_tpu_torch.exps.kernel_inputs import (deform_inputs, deform_outside_tolerance,
                                                          deform_shape, depth_label_inputs,
                                                          splat_inputs)
    from mm_training_tpu_torch.exps.timing import device_ms, host_ms
    from mm_training_tpu_torch.ops import deform_conv, depth_labels, voxel_pooling, warp

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bb = cfg.get_backbone_conf()
    d, (fh, fw), c = bb.depth_channels, bb.feat_hw, bb.output_channels
    rows = []

    def row(name, source, replaces, fn, plain, nbytes, flops, rate, plain_iters, **extra):
        bound_ms, bound_by = _bound(nbytes, flops, rate)
        rows.append(dict(name=name, route='cuda', source=f'mm_training_tpu_torch/csrc/{source}',
                         replaces=replaces, ms=device_ms(fn, 50), call_ms=host_ms(fn, 50),
                         plain_ms=device_ms(plain, plain_iters), bound_ms=bound_ms,
                         bound_by=bound_by, **extra))

    # --- K4 on the B=1 and the B=4 request's own splat indices (4 and 16
    # cameras of the fake rig), depth and ctx in the layouts the path hands
    # over under the depth oracle (a channels-last softmax, a permuted
    # channels-last slice)
    for name, bsz in (('lift_splat_factorized', 1), ('lift_splat_factorized_b4', 4)):
        depth, ctx, idx, zvalid, n_cells = args = splat_inputs(
            cfg.replace(batch_size=bsz), gen, seed=SEED + 8)
        m = idx.shape[0]
        got = voxel_pooling.lift_splat_factorized(*args)
        want = voxel_pooling.lift_splat_factorized_plain(*args)
        # the fp32 sums of the same inputs (kernel and plain), and each
        # entry's sum of |terms|, which bounds what another order of fp32
        # atomics moves
        args32 = (depth.float(), ctx.float(), idx, zvalid, n_cells)
        got32 = voxel_pooling.lift_splat_factorized(*args32)
        want32 = voxel_pooling.lift_splat_factorized_plain(*args32)
        mag = voxel_pooling.lift_splat_factorized_plain(depth.float(), ctx.float().abs(), idx,
                                                        zvalid, n_cells)
        fp32_err = ((got32 - want32).abs() / mag.clamp_min(1e-30)).max().item()
        w = want.float()
        ulp = torch.where(w == 0, 0.0, torch.exp2(torch.floor(torch.log2(w.abs())) - 7))
        diff = (got.float() - w).abs()
        ulps = torch.where(diff == 0, 0.0, diff / ulp).max().item()
        # one bf16 ulp, plus the fp32 order bound where a cell's sum cancels
        outside = int((diff > ulp + 1e-5 * mag).sum())
        rows_kept = int((idx < n_cells).sum())
        # counted by the kernel on the card, in a launch of its own
        before, after = voxel_pooling.splat_atomic_adds(*args)
        nbytes = (depth.numel() * 2 + zvalid.numel() + ctx.numel() * 2 + idx.numel() * 4
                  + got.numel() * 2)
        row(name, 'lift_splat.cu', 'mm_training_tpu/ops/voxel_pooling.py:127',
            lambda: voxel_pooling.lift_splat_factorized(*args),
            lambda: voxel_pooling.lift_splat_factorized_plain(*args),
            nbytes, 2 * fh * c * rows_kept, BF16_FLOPS, 10,
            max_abs_err=diff.max().item(), bf16_ulps=ulps, fp32_err_of_magnitude=fp32_err,
            bf16_outside_tolerance=outside, library_ms=None,
            rows_off_the_grid=int(idx.numel() - rows_kept),
            atomic_adds={'before_merge': before, 'after_merge': after,
                         'before': 'kept rows x C scalar fp32 adds the runs stand for',
                         'after': '16-byte adds issued (a run of bins x 4 channels)',
                         'counted_by': 'the kernel, on the card'},
            kept_rows_x_c=rows_kept * c,
            shape=[m, d, fh, fw, c], dtype='bfloat16')

    # --- K5 at the DepthNet's DCN (512 channels, 4 groups), offsets up to 3
    # px: the fused op at the B=1 and the B=4 request, and the columns
    # kernel (off the serving path since the fused op) at B=1. The yardsticks, timed
    # and used nowhere in the port: F.grid_sample (bilinear, zero padding,
    # align_corners=True) computing the same samples from a float32 NCHW
    # copy, one rounding and not corner by corner; torch.bmm on the bf16
    # columns, the product the fused op folds in
    for name, bsz in (('deform_conv3x3', 1), ('deform_conv3x3_b4', 4)):
        x, off, wgt, bias = dcn = deform_inputs(deform_shape(cfg.replace(batch_size=bsz)), 4,
                                                gen)
        got = deform_conv.deform_conv3x3(*dcn, 4)
        outside, err = deform_outside_tolerance(got, *dcn, 4)
        from_l2, corners = deform_conv.halo_corners(*dcn, 4)
        bm, hh, ww, cc = x.shape
        cols = deform_conv.deform_sample(x, off)
        gcols = cols.reshape(bm * hh * ww, 9, 4, cc // 4).permute(2, 0, 1, 3)
        gcols = gcols.reshape(4, -1, 9 * cc // 4)
        src = x.float().permute(0, 3, 1, 2)
        grid = _deform_grid(off)

        def sample(src=src, grid=grid):
            return torch.nn.functional.grid_sample(src, grid, mode='bilinear',
                                                   padding_mode='zeros', align_corners=True)

        def product(gcols=gcols, wgt=wgt):
            return torch.bmm(gcols, wgt)
        sample_ms, bmm_ms = device_ms(sample, 20), device_ms(product, 20)
        sampled = sample().view(bm, cc, hh, ww, 9).permute(0, 2, 3, 4, 1)
        sampled = sampled.reshape(bm, hh * ww, 9, cc)
        grid_err = (sampled - cols.float()).abs().max().item()
        flops = 2 * bm * hh * ww * wgt.shape[0] * wgt.shape[2] * wgt.shape[1]
        nbytes = (x.numel() * 2 + off.numel() * 4 + wgt.numel() * 2 + bias.numel() * 2
                  + got.numel() * 2)
        row(name, 'deform_conv.cu', 'mm_training_tpu/models/depth_net.py:46',
            lambda dcn=dcn: deform_conv.deform_conv3x3(*dcn, 4),
            lambda dcn=dcn: deform_conv.deform_conv3x3_plain(*dcn, 4),
            nbytes, flops, BF16_FLOPS, 3,
            max_abs_err=err, outside_tolerance=outside,
            library_ms=sample_ms + bmm_ms, library='F.grid_sample + torch.bmm',
            grid_sample_ms=sample_ms, bmm_ms=bmm_ms, grid_sample_max_abs_err=grid_err,
            corners_from_l2=from_l2, corners=corners,
            corners_share_beyond_halo=from_l2 / corners,
            replaces_lines='depth_net.py:46-110 without the offset conv',
            shape=list(x.shape), dtype='bfloat16')
        if bsz == 1:
            row('deform_sample', 'deform_conv.cu', 'mm_training_tpu/models/depth_net.py:56',
                lambda: deform_conv.deform_sample(x, off),
                lambda: deform_conv.deform_sample_plain(x, off),
                x.numel() * 2 + off.numel() * 4 + cols.numel() * 2, 8 * cols.numel(),
                FP32_FLOPS, 5,
                max_abs_err=(cols.float() - deform_conv.deform_sample_plain(x, off).float()
                             ).abs().max().item(),
                library_ms=sample_ms, library='F.grid_sample', library_max_abs_err=grid_err,
                note='the columns; off the serving path since the fused op',
                shape=list(x.shape), dtype='bfloat16')
        del cols, gcols, src, grid, sampled
        print(f'K5 {name}: {from_l2} of {corners} corners beyond the halo '
              f'({from_l2 / corners:.6f}), offsets up to 3 px', flush=True)

    # --- K6 on the B=1 and the B=4 request's 100k points a frame and their 4
    # and 16 cameras, the matrices as the path's strided views; the labels
    # the same bits on a second call
    for name, bsz in (('depth_labels', 1), ('depth_labels_b4', 4)):
        largs = depth_label_inputs(cfg.replace(batch_size=bsz), dev, seed=SEED + 8)
        pts, mask, extr = largs[:3]
        got = depth_labels.depth_labels(*largs)
        want = depth_labels.depth_labels_plain(*largs)
        kept = int(mask.sum())
        # the mask, x y z of the masked-in points and the matrices read, the
        # labels written; ~60 operations to project a point into a camera
        row(name, 'depth_labels.cu', 'mm_training_tpu/ops/depth_labels.py:30',
            lambda largs=largs: depth_labels.depth_labels(*largs),
            lambda largs=largs: depth_labels.depth_labels_plain(*largs),
            mask.numel() + kept * 12 + 2 * extr[..., 0, 0].numel() * 64 + got.numel() * 4,
            60 * kept * extr.shape[1], FP32_FLOPS, 20 if bsz == 1 else 5,
            max_abs_err=(got - want).abs().max().item(),
            deterministic=torch.equal(depth_labels.depth_labels(*largs), got),
            library_ms=None, cells_with_depth=int((got.argmax(-1) > 0).sum()),
            max_cells_a_camera=depth_labels.max_cells(dev),
            shape=[kept, extr.shape[0] * extr.shape[1], d], dtype='float32')
        del got, want
    # --- K6's binning alone, on a precomputed [4, 44, 80] min-depth grid
    # (a batch's depth_gt; 0 and values past the last bin go to bin 0)
    grid = torch.rand(4, fh, fw, generator=gen, device=dev) * 220
    grid.view(-1)[:3] = torch.tensor([0.0, 1.5, 206.4])
    got = depth_labels.depth_grid_to_onehot(grid, bb.d_bound, d)
    row('depth_grid_to_onehot', 'depth_labels.cu', 'mm_training_tpu/ops/depth_labels.py:76',
        lambda: depth_labels.depth_grid_to_onehot(grid, bb.d_bound, d),
        lambda: depth_labels.depth_grid_to_onehot_plain(grid, bb.d_bound, d),
        grid.numel() * 4 + got.numel() * 4, 3 * grid.numel(), FP32_FLOPS, 20,
        max_abs_err=(got - depth_labels.depth_grid_to_onehot_plain(grid, bb.d_bound, d)
                     ).abs().max().item(),
        deterministic=torch.equal(depth_labels.depth_grid_to_onehot(grid, bb.d_bound, d), got),
        library_ms=None, shape=list(grid.shape) + [d], dtype='float32')
    del got

    # --- K7 on the camera BEV (32 x 256 x 80 bf16) with a rotated, flipped
    # and scaled augmentation, as the path calls it (the BDA matrix in, the
    # warped map out), and warp_affine_nhwc on a projective matrix; the
    # yardstick is F.grid_sample on a float32 copy with the same source
    # pixels (align_corners=True: pixel centres)
    bev = torch.randn(1, *bb.bev_hw, c, generator=gen, device=dev).bfloat16()
    bda = torch.as_tensor(random_bda_matrices(1, SEED + 9), device=dev)
    got = warp.bda_bev_warp(bev, bda)
    want = warp.bda_bev_warp_plain(bev, bda)
    mat = warp.bda_pixel_matrix(bda, bb.bev_hw)
    proj = mat + torch.tensor([[0, 0, 0], [0, 0, 0], [2e-4, -1e-4, 0]], device=dev)
    proj_err = (warp.warp_affine_nhwc(bev, proj).float()
                - warp.warp_affine_nhwc_plain(bev, proj).float()).abs().max().item()
    grid = _warp_grid(torch.linalg.inv(mat), *bb.bev_hw)
    src = bev.float().permute(0, 3, 1, 2)

    def library():
        return torch.nn.functional.grid_sample(src, grid, mode='bilinear', padding_mode='zeros',
                                               align_corners=True)
    lib_err = (library().permute(0, 2, 3, 1) - want.float()).abs().max().item()
    row('bda_bev_warp', 'bev_warp.cu', 'mm_training_tpu/ops/warp.py:75',
        lambda: warp.bda_bev_warp(bev, bda), lambda: warp.bda_bev_warp_plain(bev, bda),
        2 * bev.numel() * 2 + bda.numel() * 4, 0, FP32_FLOPS, 20,
        max_abs_err=(got.float() - want.float()).abs().max().item(),
        projective_max_abs_err=proj_err,
        library_ms=device_ms(library, 50), library_max_abs_err=lib_err,
        shape=list(bev.shape), dtype='bfloat16')

    for r in rows:
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']} ms={r['ms']:.6f} "
              f"call_ms={r['call_ms']:.6f} plain_ms={r['plain_ms']:.6f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms={r['library_ms']}",
              flush=True)
    by = {r['name']: r for r in rows}
    # K4: fp32 atomics add in another order (1e-5 of the sum of |terms|);
    # after the cast, one bf16 ulp plus that where a cell's sum cancels
    for name in ('lift_splat_factorized', 'lift_splat_factorized_b4'):
        k4 = by[name]
        # every kept row added once, in fewer 16-byte adds than rows x C / 4
        adds = k4['atomic_adds']
        if not (k4['fp32_err_of_magnitude'] <= 1e-5 and k4['bf16_outside_tolerance'] == 0
                and adds['before_merge'] == k4['kept_rows_x_c']
                and 0 < 4 * adds['after_merge'] < adds['before_merge']):
            raise AssertionError(f'{name} differs from its plain version: {k4}')
    for name in ('deform_conv3x3', 'deform_conv3x3_b4'):
        # the samples bit for bit, the fp32 sums in another order than the
        # plain version's: kernel and plain outputs each the op's rounding
        # (sum, then bias) of a sum within 1e-5 of the sum of |terms| of the
        # exact sum; the check offsets (3 px) stay inside the halo
        k5 = by[name]
        if k5['outside_tolerance'] or k5['corners_from_l2']:
            raise AssertionError(f'{name} differs from its plain version: {k5}')
    for name in ('deform_sample', 'depth_labels', 'depth_labels_b4', 'depth_grid_to_onehot',
                 'bda_bev_warp'):   # bit for bit
        if by[name]['max_abs_err'] != 0 or not by[name].get('deterministic', True):
            raise AssertionError(f'{name} differs from its plain version: {by[name]}')
    k7 = by['bda_bev_warp']
    if k7['projective_max_abs_err'] != 0:
        raise AssertionError(f'warp_affine_nhwc differs from its plain version: {k7}')
    if not (by['depth_labels']['cells_with_depth'] > 0
            and by['depth_labels_b4']['cells_with_depth'] > 0):
        raise AssertionError('no LiDAR point reached a camera')
    return rows


def serve_camera(cfg, pitch_deg=0.0, iters=(60, 20)):
    """Phase 8 (and 15 on the raw rig): the full-width camera + LiDAR + radar
    predict path; ``pitch_deg`` pitches the fake rig's cameras, ``iters``
    are the B=1 and B=4 latency samples. The splat is K4 for the factorized
    config and K8 for the raw-rig one, and the other is never launched."""
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.exps.inference import benchmark_latency
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.models.depth_net import DeformConv2d
    from mm_training_tpu_torch.ops import deform_conv
    from mm_training_tpu_torch.training import make_predict_step

    gen = torch.Generator().manual_seed(SEED + 10)
    model = BEVDepthLiDAR(cfg, device='cuda', generator=gen)
    _randomize_bn(model, gen)
    _randomize_offsets(model, gen)
    fused_dtypes = set()
    model.head.register_forward_pre_hook(lambda mod, args: fused_dtypes.add(args[0].dtype))
    dcn_inputs = []   # (the predict step's DCN, its input), first call only

    def keep_dcn_input(mod, args):
        if not dcn_inputs:
            dcn_inputs.append((mod, args[0]))
    next(m for m in model.modules() if isinstance(m, DeformConv2d)).register_forward_pre_hook(
        keep_dcn_input)
    predict = make_predict_step(cfg, model)
    requests = [make_fake_batch(cfg, batch_size=1, seed=SEED + 11 + i, pitch_deg=pitch_deg)
                for i in range(3)]
    big = make_fake_batch(cfg, batch_size=4, seed=SEED + 20, pitch_deg=pitch_deg)
    wrappers = _wrappers()
    raw = not cfg.get_backbone_conf().factorized_splat
    label = 'raw-rig camera' if raw else 'camera'
    splat, other = (('lift_splat', 'lift_splat_factorized') if raw
                    else ('lift_splat_factorized', 'lift_splat'))

    bmm_calls = []
    bmm = torch.bmm

    def counted_bmm(*a, **k):
        bmm_calls.append(1)
        return bmm(*a, **k)

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    outs, lat = [], []
    with mock.patch.object(torch, 'bmm', counted_bmm):
        for req in requests:
            t0 = time.perf_counter()
            outs.append([o.cpu() for o in predict(req)])
            lat.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        out_big = [o.cpu() for o in predict(big)]
        lat_big = (time.perf_counter() - t0) * 1e3
    stats = benchmark_latency(predict, requests[0], iters=iters[0])
    stats_b4 = benchmark_latency(predict, big, iters=iters[1])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {n: w.launches for n, w in wrappers.items()}
    calls = len(requests) + 1 + (stats['samples'] + 1) + (stats_b4['samples'] + 1)
    # the peak of one B=4 request alone, after the warm ones above
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    [o.cpu() for o in predict(big)]
    peak_b4_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'serve {label}: peak device memory of one B=4 request {peak_b4_gib:.4f} GiB, '
          f'{peak_b4_gib - base_gib:.4f} GiB above the {base_gib:.4f} GiB held between '
          f'requests (before the fused K5, the factorized config: '
          f'{BEFORE_CAMERA_B4_ABOVE_GIB} GiB above); torch.bmm calls on the path '
          f'{len(bmm_calls)}', flush=True)
    # the share of bilinear corners the fused K5 read from L2 on the path's
    # own offsets (the DepthNet's input of the first request)
    with torch.inference_mode():
        dcn, x = dcn_inputs[0]
        offsets = dcn.conv_offset(x).permute(0, 2, 3, 1).float()
        from_l2, corners = deform_conv.halo_corners(
            x.permute(0, 2, 3, 1), offsets, dcn.packed_weight(x.dtype), dcn.bias.to(x.dtype),
            dcn.groups)
        off_abs = offsets.abs()
    print(f'K5 on the path: {from_l2} of {corners} corners beyond the halo '
          f'({from_l2 / corners:.6f}); |offset| mean {off_abs.mean().item():.4f} px, '
          f'99.9th percentile {off_abs.flatten().float().quantile(0.999).item():.4f} px, '
          f'max {off_abs.max().item():.4f} px', flush=True)
    _path_device_ops(f'lidar_cam_radar{" raw-rig" if raw else ""} B=1 request',
                     lambda: [o.cpu() for o in predict(requests[0])])

    print(f'serve {label}: {len(requests)} B=1 requests {[round(v, 3) for v in lat]} ms '
          f'(first includes warm-up), B=4 batch {lat_big:.3f} ms; '
          f'max_memory_allocated {peak_gib:.3f} GiB', flush=True)
    print(f'serve {label} latency B=1: ' + json.dumps(stats), flush=True)
    print(f'serve {label} latency B=4: ' + json.dumps(stats_b4), flush=True)
    print(f'serve {label}: launches over {calls} predict calls {json.dumps(counts)}; '
          f'fused BEV dtypes {sorted(map(str, fused_dtypes))}', flush=True)
    missing = [n for n in ('affine_act', 'pillar_encoder_input', 'circle_nms_mask', splat,
                           'deform_conv3x3', 'depth_labels', 'bda_bev_warp') if counts[n] == 0]
    if missing:
        raise AssertionError(f'kernels never launched on the {label} path: {missing}')
    if counts[other]:
        raise AssertionError(f'the {label} path launched {other}: {counts}')
    # the fused K5 holds no column tensor: no columns kernel, no batched
    # product; the encoder takes K1's own layout
    if counts['deform_sample'] or counts['voxelize_pillars_dense'] or bmm_calls:
        raise AssertionError(f'the camera path launched the columns kernel, K1 in its plain '
                             f'layout or torch.bmm: {counts}, {len(bmm_calls)} bmm calls')
    if fused_dtypes != {torch.bfloat16}:
        raise AssertionError(f'the fused BEV entering the head is {fused_dtypes}, not bf16')
    n_out = len(cfg.get_head_conf().tasks) * cfg.get_head_conf().test_cfg.post_max_size
    for o, b in [(o, 1) for o in outs] + [(out_big, 4)]:
        boxes, scores, labels, valid = o
        if boxes.shape != (b, n_out, 9) or scores.shape != (b, n_out):
            raise AssertionError(f'unexpected output shapes {boxes.shape} {scores.shape}')
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
            raise AssertionError('non-finite boxes or scores')
        if not valid.any(1).all():
            raise AssertionError('a request decoded no box')
    stats['max_memory_allocated_gib'] = peak_gib
    stats_b4['max_memory_allocated_one_request_gib'] = peak_b4_gib
    stats_b4['one_request_above_held_gib'] = peak_b4_gib - base_gib
    return model, requests[0], counts, calls, (stats, stats_b4)


def compare_plain_camera(model, cfg, request):
    """Phase 9a: pred maps of one camera request through the kernels vs the
    plain versions (bf16), once with the depth oracle and a rotated,
    flipped and scaled BEV augmentation, once without the oracle (the DCN's
    softmax depth reaches the splat)."""
    from mm_training_tpu_torch.data import random_bda_matrices
    from mm_training_tpu_torch.training import camera_inputs, cast_floating

    net = cast_floating(model, torch.bfloat16)
    pts = torch.as_tensor(request['points'], device='cuda')
    mask = torch.as_tensor(request['point_mask'], device='cuda')
    worst = {}
    for label, c, req in (
            ('oracle, rotated BDA', cfg,
             dict(request, bda_mat=random_bda_matrices(1, SEED + 12))),
            ('no oracle', cfg.replace(use_depth_loss=False), request)):
        with torch.inference_mode():
            got = net(pts, mask, **camera_inputs(c, req, 'cuda', pts, mask))
            before = {n: w.launches for n, w in _wrappers().items()}
            with _plain_versions():
                want = net(pts, mask, **camera_inputs(c, req, 'cuda', pts, mask))
            if {n: w.launches for n, w in _wrappers().items()} != before:
                raise AssertionError('the plain run launched a kernel')
        # K6, K7 and A match bit for bit; the atomics of K1 and K4 and K5's
        # fp32 sums in another order move sums by fp32 ulps, which can flip
        # a bf16 rounding and travel through the bf16 layers after them:
        # allow 1/32 of the map's scale
        worst[label] = max(((g[k].float() - w[k].float()).abs().max()
                            / w[k].float().abs().max().clamp_min(1.0)).item()
                           for g, w in zip(got, want) for k in w)
    print('camera plain-path pred maps (bf16): worst max|diff| / max|map| '
          + json.dumps(worst), flush=True)
    if not all(v <= 1 / 32 for v in worst.values()):
        raise AssertionError(f'kernel and plain camera pred maps differ: {worst}')
    return worst


def check_backward_kernels(cfg):
    """Phase 10: the backward kernels K4', K5' and K7' against their plain
    versions (autograd through the plain forward) at the camera train
    path's shapes, B=1 and B=4, in bf16 and float32, with the tolerances of
    ``exps/backward_checks.py``; each one's time, its plain version's, the
    library calls of the route it replaced where there are any, and its
    bound (their device ops a call are phase 1's)."""
    from mm_training_tpu_torch.data import random_bda_matrices
    from mm_training_tpu_torch.exps import backward_checks
    from mm_training_tpu_torch.exps.kernel_inputs import (deform_inputs, deform_shape,
                                                          splat_inputs)
    from mm_training_tpu_torch.exps.timing import device_ms, host_ms
    from mm_training_tpu_torch.ops import deform_conv, voxel_pooling, warp

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    bb = cfg.get_backbone_conf()
    c = bb.output_channels
    rows, checks = [], {}

    def row(name, source, replaces, fn, plain, nbytes, flops, rate, plain_iters, **extra):
        bound_ms, bound_by = _bound(nbytes, flops, rate)
        rows.append(dict(name=name, route='cuda', source=f'mm_training_tpu_torch/csrc/{source}',
                         replaces=replaces, ms=device_ms(fn, 20), call_ms=host_ms(fn, 20),
                         plain_ms=device_ms(plain, plain_iters), bound_ms=bound_ms,
                         bound_by=bound_by, **extra))

    for bsz in (1, 4):
        suffix = '' if bsz == 1 else '_b4'
        b4 = cfg.replace(batch_size=bsz)
        # --- K4': the splat's gradient on the fake rig's own indices, depth
        # as the oracle's where leaves it (channels-last) and as the softmax
        # without the oracle (NCHW)
        for layout in ('channels_last', 'nchw'):
            for dtype in (torch.bfloat16, torch.float32):
                args = splat_inputs(b4, gen, layout, dtype, seed=SEED + 8)
                g = torch.randn(args[2].shape[0], args[4], c, generator=gen,
                                device=dev).to(dtype)
                checks[f'lift_splat_backward B={bsz} {layout} {dtype}'] = \
                    backward_checks.splat_backward_errors(*args, g)
        depth, ctx, idx, zvalid, n_cells = args = splat_inputs(b4, gen, seed=SEED + 8)
        g = torch.randn(idx.shape[0], n_cells, c, generator=gen, device=dev).bfloat16()
        active = int((zvalid & (idx < n_cells)[:, :, None, :]).sum())
        res = checks[f'lift_splat_backward B={bsz} channels_last {torch.bfloat16}']
        row('lift_splat_factorized_backward' + suffix, 'lift_splat_backward.cu',
            'mm_training_tpu/ops/voxel_pooling.py:127 (its autodiff; no TPU kernel)',
            lambda args=args, g=g: voxel_pooling.lift_splat_factorized_backward(g, *args),
            lambda args=args, g=g: voxel_pooling.lift_splat_factorized_backward_plain(g, *args),
            depth.numel() * 2 * 2 + zvalid.numel() + ctx.numel() * 2 * 2 + idx.numel() * 4
            + g.numel() * 2, 2 * 2 * active * c, BF16_FLOPS, 3,
            max_abs_err=res['max_abs_err'], library_ms=None, deterministic=res['deterministic'],
            shape=list(depth.shape) + [c], dtype='bfloat16')
        del args, depth, ctx, idx, zvalid, g

        # --- K7': the camera BEV's gradient under a rotated, flipped and
        # scaled augmentation; the yardstick is aten's grid_sampler_2d_backward
        # (the input's gradient of F.grid_sample, float32 NCHW)
        bda = torch.as_tensor(random_bda_matrices(bsz, SEED + 31), device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            img = torch.randn(bsz, *bb.bev_hw, c, generator=gen, device=dev).to(dtype)
            gw = torch.randn(img.shape, generator=gen, device=dev).to(dtype)
            checks[f'warp_backward B={bsz} {dtype}'] = backward_checks.warp_backward_errors(
                img, bda, 4, gw)
            proj = warp.bda_pixel_matrix(bda, bb.bev_hw)
            proj[:, 2, :2] = 1e-4
            checks[f'warp_backward projective B={bsz} {dtype}'] = \
                backward_checks.warp_backward_errors(img, proj, 0, gw)
        img = torch.randn(bsz, *bb.bev_hw, c, generator=gen, device=dev).bfloat16()
        gw = torch.randn(img.shape, generator=gen, device=dev).bfloat16()
        grid = _warp_grid(torch.linalg.inv(warp.bda_pixel_matrix(bda, bb.bev_hw)), *bb.bev_hw)
        src32, g32 = img.float().permute(0, 3, 1, 2), gw.float().permute(0, 3, 1, 2)

        def library(src32=src32, g32=g32, grid=grid):
            return torch.ops.aten.grid_sampler_2d_backward(g32, src32, grid, 0, 0, True,
                                                           [True, False])
        row('warp_backward' + suffix, 'bev_warp.cu',
            'mm_training_tpu/ops/warp.py:75 (its autodiff; no TPU kernel)',
            lambda img=img, gw=gw, bda=bda: warp.warp_backward(gw, img, bda, 4),
            lambda img=img, gw=gw, bda=bda: warp.warp_backward_plain(gw, img, bda, 4),
            2 * img.numel() * 2 + bda.numel() * 4, 8 * img.numel(), FP32_FLOPS, 10,
            max_abs_err=checks[f'warp_backward B={bsz} {torch.bfloat16}']['max_abs_err'],
            deterministic=checks[f'warp_backward B={bsz} {torch.bfloat16}']['deterministic'],
            library_ms=device_ms(library, 20), library='aten.grid_sampler_2d_backward (fp32)',
            shape=list(img.shape), dtype='bfloat16')
        del img, gw, src32, g32, grid

        # --- K5': the DCN's whole backward (d x, d offsets, d weight, d
        # bias) at the path's shapes, offsets up to 3 px and at whole pixels
        # (the train path's zero-initialised offset conv), bf16 and float32.
        # The yardstick, timed here and used nowhere in the port: the library
        # calls of the route it replaced, grid_sampler_2d_backward's input
        # and grid gradients over the 9 taps (float32 NCHW) and the ten
        # torch.bmm of the grouped products on the columns
        shape = deform_shape(b4)
        for dtype in (torch.bfloat16, torch.float32):
            for reach in (3.0, 0.0):
                x, off, wgt, bias = deform_inputs(shape, 4, gen, dtype, reach)
                dy = torch.randn(*shape[:3], wgt.shape[0] * wgt.shape[2], generator=gen,
                                 device=dev).to(dtype)
                checks[f'deform_backward B={bsz} {dtype} offsets {reach} px'] = \
                    backward_checks.deform_backward_errors(x, off, wgt, bias, 4, dy)
                del x, off, wgt, bias, dy
        x, off, wgt, bias = dcn = deform_inputs(shape, 4, gen)
        dy = torch.randn(*shape[:3], wgt.shape[0] * wgt.shape[2], generator=gen,
                         device=dev).bfloat16()
        bm, hh, ww, cc = x.shape
        og = wgt.shape[2]
        cols = deform_conv.deform_sample(x, off).view(bm * hh * ww, 9, 4, cc // 4)
        dyg, wt = dy.view(-1, 4, og).transpose(0, 1), wgt.transpose(1, 2)
        grid9 = _deform_grid(off)
        x32 = x.float().permute(0, 3, 1, 2)
        g9 = torch.bmm(dyg, wt).view(4, bm, hh, ww, 9, cc // 4).permute(1, 0, 5, 2, 3, 4)
        g9 = g9.reshape(bm, cc, hh, ww * 9).float()

        def sampler(x32=x32, g9=g9, grid9=grid9):
            return torch.ops.aten.grid_sampler_2d_backward(g9, x32, grid9, 0, 0, True,
                                                           [True, True])

        def products(cols=cols, dyg=dyg, wt=wt):
            return ([torch.bmm(cols[:, t].permute(1, 2, 0), dyg) for t in range(9)],
                    torch.bmm(dyg, wt))
        sampler_ms, bmm_ms = device_ms(sampler, 5), device_ms(products, 5)
        whole = (dy, x, torch.zeros_like(off), wgt, bias)
        res = checks[f'deform_backward B={bsz} {torch.bfloat16} offsets 3.0 px']
        # x and dy read, the offsets, weights and bias read and their
        # gradients written; the two grouped products on the tensor cores
        row('deform_conv3x3_backward' + suffix, 'deform_conv.cu',
            'mm_training_tpu/models/depth_net.py:46 (its autodiff; no TPU kernel)',
            lambda a=(dy, *dcn): deform_conv.deform_conv3x3_backward(*a, 4),
            lambda a=(dy, *dcn): deform_conv.deform_conv3x3_backward_plain(*a, 4),
            (x.numel() * 2 + dy.numel()) * 2 + off.numel() * 4 * 2
            + (wgt.numel() + bias.numel()) * 2 * 2, 2 * 2 * bm * hh * ww * 9 * cc * og,
            BF16_FLOPS, 2,
            max_abs_err=res['max_abs_err'], deterministic=res['deterministic'],
            library_ms=sampler_ms + bmm_ms,
            library='aten.grid_sampler_2d_backward (fp32, input and grid) + the ten torch.bmm '
                    'of the grouped products',
            grid_sampler_ms=sampler_ms, bmm_ms=bmm_ms,
            whole_pixels_ms=device_ms(lambda: deform_conv.deform_conv3x3_backward(*whole, 4), 20),
            shape=list(x.shape), dtype='bfloat16')
        del x, off, wgt, bias, dy, dcn, cols, dyg, wt, x32, g9, grid9, whole

    for r in rows:
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']} ms={r['ms']:.6f} "
              f"call_ms={r['call_ms']:.6f} plain_ms={r['plain_ms']:.6f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms={r['library_ms']}",
              flush=True)
    print('backward kernels against their plain versions: ' + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk in ('ok', 'max_abs_err')}
         for k, v in checks.items()}), flush=True)
    bad = {k: v for k, v in checks.items() if not v['ok']}
    if bad:
        raise AssertionError(f'backward kernels differ from their plain versions: {bad}')
    return rows


def check_raw_splat_kernels(cfg):
    """Phase 14: kernels K8 (``lift_splat``) and K8' (``lift_splat_backward``)
    against their plain versions at the raw-rig path's B=1 and B=4 shapes
    (4 and 16 cameras x 409 bins x 44 x 80 pixels, C 80, 8192 cells), on the
    pitched fake rig's own indices, in bf16 and float32, depth channels-last
    (under the depth oracle) and NCHW (without it), with the tolerances of
    ``exps/backward_checks.py``; K8' also the same bits on a second call.
    Each timed as phase 2 times kernels, beside its bound and its plain
    time; K8 with the counts one launch keeps on the card (it must scatter
    each kept row once), the float atomics in its built SASS (none; K4's,
    which has them, read the same way so that the scan is seen to find
    them) and the interval statistics of the rig's cells. No single
    PyTorch call computes either: no library time."""
    from mm_training_tpu_torch.exps import backward_checks
    from mm_training_tpu_torch.exps.kernel_inputs import raw_interval_stats, raw_splat_inputs
    from mm_training_tpu_torch.exps.timing import device_ms, host_ms
    from mm_training_tpu_torch.ops import build, voxel_pooling

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    sass = {'lift_splat_raw_kernel': build.float_atomics('lift_splat_raw',
                                                         'lift_splat_raw_kernel'),
            'k4_lift_splat_kernel': build.float_atomics('lift_splat', 'lift_splat_kernel')}
    c = cfg.get_backbone_conf().output_channels
    rows, checks = [], {}
    for bsz in (1, 4):
        suffix = '' if bsz == 1 else '_b4'
        b4 = cfg.replace(batch_size=bsz)
        for layout in ('channels_last', 'nchw'):
            for dtype in (torch.bfloat16, torch.float32):
                depth, ctx, idx, n_cells = args = raw_splat_inputs(b4, gen, layout, dtype,
                                                                   seed=SEED + 8)
                g = torch.randn(idx.shape[0], n_cells, c, generator=gen, device=dev).to(dtype)
                checks[f'lift_splat B={bsz} {layout} {dtype}'] = \
                    backward_checks.raw_splat_errors(*args)
                checks[f'lift_splat_backward B={bsz} {layout} {dtype}'] = \
                    backward_checks.raw_splat_backward_errors(*args, g)
                del depth, ctx, idx, g, args
        depth, ctx, idx, n_cells = args = raw_splat_inputs(b4, gen, seed=SEED + 8)
        g = torch.randn(idx.shape[0], n_cells, c, generator=gen, device=dev).bfloat16()
        kept = int((idx < n_cells).sum())
        counted = voxel_pooling.raw_splat_atomic_adds(*args)
        intervals = raw_interval_stats(idx, n_cells)
        # depth, ctx and the indices read once, the BEV written once; a
        # product and an add a kept (row, channel)
        nbytes = depth.numel() * 2 + ctx.numel() * 2 + idx.numel() * 4 + g.numel() * 2
        for name, fn, plain, total, flops, extra in (
                ('lift_splat', lambda a=args: voxel_pooling.lift_splat(*a),
                 lambda a=args: voxel_pooling.lift_splat_plain(*a), nbytes, 2 * kept * c,
                 dict(atomic_adds=dict(counted, counted_by='the kernel, on the card'),
                      float_atomics_in_sass=sum(sass['lift_splat_raw_kernel'].values()),
                      intervals=intervals, kept_rows=kept,
                      rows_off_the_grid=int(idx.numel() - kept))),
                ('lift_splat_backward',
                 lambda a=args, g=g: voxel_pooling.lift_splat_backward(g, *a),
                 lambda a=args, g=g: voxel_pooling.lift_splat_backward_plain(g, *a),
                 nbytes + depth.numel() * 2 + ctx.numel() * 2, 4 * kept * c, {})):
            res = checks[f'{name} B={bsz} channels_last {torch.bfloat16}']
            bound_ms, bound_by = _bound(total, flops, FP32_FLOPS)
            rows.append(dict(
                name=name + suffix, route='cuda',
                source='mm_training_tpu_torch/csrc/lift_splat_raw.cu',
                replaces='mm_training_tpu/ops/voxel_pooling.py:83' + (
                    '' if name == 'lift_splat' else ' (its autodiff; no TPU kernel)'),
                ms=device_ms(fn, 20), call_ms=host_ms(fn, 20), plain_ms=device_ms(plain, 2),
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=res['max_abs_err'],
                deterministic=res.get('deterministic'), library_ms=None,
                shape=list(depth.shape) + [c], dtype='bfloat16', **extra))
        del depth, ctx, idx, g, args
    for r in rows:
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']} ms={r['ms']:.6f} "
              f"call_ms={r['call_ms']:.6f} plain_ms={r['plain_ms']:.6f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) library_ms={r['library_ms']}",
              flush=True)
    print('raw-rig splat kernels against their plain versions: ' + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk in ('ok', 'max_abs_err', 'deterministic')}
         for k, v in checks.items()}), flush=True)
    for r in rows:
        if 'atomic_adds' in r:
            print(f"kernel {r['name']}: counted on the card {json.dumps(r['atomic_adds'])}; "
                  f"intervals {json.dumps(r['intervals'])}", flush=True)
    print('float atomics in the SASS (cuobjdump -sass of the built libraries): '
          + json.dumps(sass), flush=True)
    bad = {k: v for k, v in checks.items() if not v['ok']}
    if any(sass['lift_splat_raw_kernel'].values()) or not any(
            sass['k4_lift_splat_kernel'].values()):
        bad['float atomics in the SASS'] = sass
    for r in rows:
        adds = r.get('atomic_adds')
        if adds and not (adds['kept_rows'] == r['kept_rows']
                         and 0 < adds['scatter_int_atomics'] <= adds['kept_rows']):
            bad[r['name']] = adds
    if bad:
        raise AssertionError(f'the raw-rig splat kernels differ from their plain versions: {bad}')
    return rows


def _camera_draws(cfg, imgs_shape, seed, device, flipped=None):
    """A camera train step's random draws from a CPU generator (the same
    bits on any device), moved to ``device``; ``flipped`` overrides the flips."""
    from mm_training_tpu_torch.training import draw_train_randoms
    d = draw_train_randoms(cfg, imgs_shape, torch.Generator().manual_seed(seed), 'cpu')
    if flipped is not None:
        d['flipped'] = torch.as_tensor(flipped)
    return {'flipped': d['flipped'].to(device),
            'dropout': [k.to(device) for k in d['dropout']]}


CAMERA_TRAIN_KERNELS = ('affine_act', 'affine_act_backward', 'pillar_encoder_input',
                        'draw_heatmap', 'circle_nms_mask', 'lift_splat_factorized',
                        'lift_splat_factorized_backward', 'deform_conv3x3',
                        'deform_conv3x3_backward', 'depth_labels', 'bda_bev_warp',
                        'warp_backward')


def train_camera(cfg, pitch_deg=0.0, steps=10):
    """Phase 11 (and 17 on the raw rig): the full-width ``lidar_cam_radar``
    train path at B=4 through its entry points (bf16 compute over float32
    masters, one fixed fake batch with a rotated BEV augmentation and its
    cameras pitched by ``pitch_deg``, the step's own random flips and
    dropout from its generator, seeded with the config's seed): 2 warm-up
    steps, ``steps`` timed steps, one eval step, every kernel's launch count
    reset before and read after. The splat is K4 and K4' for the factorized
    config and K8 and K8' for the raw-rig one, and the other pair is never
    launched."""
    from mm_training_tpu_torch.exps.profile_train import benchmark_train, train_batch
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.training import (create_train_state, make_eval_step,
                                                make_train_step)

    cfg = cfg.replace(batch_size=4)
    model = BEVDepthLiDAR(cfg, device='cuda', generator=torch.Generator().manual_seed(SEED + 32))
    state = create_train_state(cfg, model)
    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)
    batch = train_batch(cfg, SEED + 34, pitch_deg)
    wrappers = _wrappers()
    parts = []
    raw = not cfg.get_backbone_conf().factorized_splat
    label = 'raw-rig camera' if raw else 'camera'
    swap = {'lift_splat_factorized': 'lift_splat',
            'lift_splat_factorized_backward': 'lift_splat_backward'}
    expected = [swap.get(n, n) if raw else n for n in CAMERA_TRAIN_KERNELS]
    never = ['voxelize_pillars_dense', 'deform_sample'] + [
        n for pair in swap.items() for n in pair if n not in expected]

    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(2):
        state, metrics = train_step(state, batch)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3

    def step(state, batch):
        state, m = train_step(state, batch)
        parts.append((m['train_detection_loss'], m['train_depth_loss']))
        return state, m
    stats = benchmark_train(step, state, batch, steps=steps)
    ev_metrics, (boxes, scores, _, _), viz = eval_step(state, batch)
    torch.cuda.synchronize()
    counts = {n: w.launches for n, w in wrappers.items()}
    parts = [(float(a), float(b)) for a, b in parts]

    print(f'train {label}: 2 warm-up steps {warm_ms:.3f} ms; B=4 step p50 '
          f'{stats["p50_ms"]:.3f} ms p90 {stats["p90_ms"]:.3f} ms, '
          f'{stats["samples_per_s"]:.3f} samples/s, peak device memory (warm-up and timed '
          f'steps) {stats["max_memory_allocated_gb"]:.3f} GiB', flush=True)
    print(f'train {label}: losses ' + json.dumps([round(v, 4) for v in stats['losses']])
          + '; (detection, depth) ' + json.dumps([(round(a, 4), round(b, 4)) for a, b in parts])
          + f'; eval loss {float(ev_metrics["loss"]):.4f} (depth '
          f'{float(ev_metrics["depth_loss"]):.4f})', flush=True)
    print(f'train {label}: launches over {steps + 2} train steps and 1 eval step '
          f'{json.dumps(counts)}', flush=True)
    missing = [n for n in expected if counts[n] == 0]
    if missing:
        raise AssertionError(f'kernels never launched on the {label} train path: {missing}')
    if any(counts[n] for n in never):
        raise AssertionError(f'the {label} train path launched one of {never}: {counts}')
    if raw and (counts['lift_splat'], counts['lift_splat_backward']) != (steps + 3, steps + 2):
        raise AssertionError(f'K8 and K8\' are not launched once a step: {counts}')
    if not (all(np.isfinite(stats['losses'])) and np.isfinite(parts).all()
            and torch.isfinite(ev_metrics['loss'])):
        raise AssertionError('non-finite camera train or eval loss')
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()
            and torch.isfinite(viz['depth']).all()):
        raise AssertionError('non-finite camera eval boxes or depth')
    # counted in a process of its own (one warm-up step there): after the
    # kernels have launched from autograd's device thread, later profiler
    # sessions of a process have come back empty (PERF.md section 7)
    del state, model
    torch.cuda.empty_cache()
    out = subprocess.run([sys.executable, '-m', 'mm_training_tpu_torch.exps.profile_train',
                          '--config', 'lidar_cam_radar', '--batch-size', '4', '--warmup', '1',
                          '--ops-only'] + (['--raw-rig'] if raw else []),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f'counting the {label} train step\'s device ops failed:\n'
                             f'{out.stderr[-3000:]}')
    n_ops = json.loads(out.stdout.strip().splitlines()[-1])['device_ops_one_step']
    print(f'device ops of one {label} lidar_cam_radar B=4 train step: {n_ops} (a process of '
          f'its own)', flush=True)
    stats['device_ops_one_step'] = n_ops
    stats['warm_up_ms'] = warm_ms
    return counts, stats


def compare_plain_gradients_camera(cfg, pitch_deg=0.0):
    """Phase 12 (and 18 on the raw rig, its cameras pitched by
    ``pitch_deg``): one full-width ``lidar_cam_radar`` step at B=1 (random DCN
    offsets, so K5 interpolates; a rotated BEV augmentation; one image
    flipped; the same dropout masks) through the kernels against the same
    step with every kernel swapped for its plain version: gradients and
    loss within 1/32 (L2), with the depth oracle and with
    ``use_depth_loss=False`` (the DepthNet's depth reaches the splat).

    In float32 compute (TF32 off): in bf16 the plain path is no yardstick
    at this width. Its CUDA ``index_add_`` and ``index_put_`` add in no
    fixed order, some in bf16, and the roundings they flip reach the
    train-mode BatchNorms, whose backward amplifies them: two runs of the
    plain step differ by 0.160 (L2) without the oracle, against 0.003 in
    float32 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6). The plain
    path's own run-to-run difference is printed beside each comparison."""
    from mm_training_tpu_torch.exps.profile_train import train_batch
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.training import create_train_state, loss_and_grads

    torch.backends.cudnn.allow_tf32 = False        # fp32 comparison: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 35)
    cfg = cfg.replace(batch_size=1, precision='fp32')
    model = BEVDepthLiDAR(cfg, device='cuda', generator=gen)
    _randomize_offsets(model, gen)
    state = create_train_state(cfg, model)
    batch = train_batch(cfg, SEED + 36, pitch_deg)
    draws = _camera_draws(cfg, batch['imgs'].shape, SEED + 37, 'cuda',
                          flipped=[True, False, False, False])
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    names = [n for n, _ in model.named_parameters()]

    def l2(ts):
        return torch.sqrt(sum((t.double() ** 2).sum() for t in ts))
    out = {}
    for label, c in (('oracle', cfg), ('no oracle', cfg.replace(use_depth_loss=False))):
        loss, got, _ = loss_and_grads(c, state, batch, draws)
        model.load_state_dict(buffers, strict=False)
        before = {n: w.launches for n, w in _wrappers().items()}
        with _plain_versions():
            plain = [loss_and_grads(c, state, batch, draws) for _ in range(2)]
            model.load_state_dict(buffers, strict=False)
        if {n: w.launches for n, w in _wrappers().items()} != before:
            raise AssertionError('the plain run launched a kernel')
        loss_p, want, _ = plain[0]
        rel = (l2([a - b for a, b in zip(got, want)]) / l2(want)).item()
        floor = (l2([a - b for a, b in zip(plain[1][1], want)]) / l2(want)).item()
        per = sorted(((((a - b).norm() / b.norm().clamp_min(1e-30)).item(), n)
                      for a, b, n in zip(got, want, names)), reverse=True)
        loss_rel = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
        out[label] = {'grad_rel_l2': rel, 'plain_run_to_run_rel_l2': floor,
                      'loss_rel': loss_rel,
                      'worst_tensors': [(n, round(v, 5)) for v, n in per[:4]]}
    raw = not cfg.get_backbone_conf().factorized_splat
    print(f'{"raw-rig " if raw else ""}camera train gradients kernels vs plain (fp32, B=1): '
          + json.dumps(out), flush=True)
    # the float32 sums of K1, K4, K4', K5, K5', K7' and A' (and of the
    # plain versions' index_add_) in another order: allow 1/32 over all
    # parameters, as phase 5b does
    if not all(v['grad_rel_l2'] <= 1 / 32 and v['loss_rel'] <= 1 / 32 for v in out.values()):
        raise AssertionError(f'kernel and plain camera gradients differ: {out}')
    return out


TRAINER_KERNELS = ('affine_act', 'affine_act_backward', 'pillar_encoder_input', 'draw_heatmap',
                   'circle_nms_mask')
TREE_FRAMES = {'train': 16, 'val': 8}
FISHEYE_TRAIN_FRAMES = 8
# the trainer runs of phases 21-23 (lidar_radar) and 25-27 (lidar_cam_radar):
# the kernels each must launch, the config exps.evaluate takes on 'best'
# (the tree holds the writer's 'highway' odd only; eval_lidar_radar reads
# 'night', so its eval_split is reset) and the kernels a run must never
# launch
TRAINER_RUNS = {
    'lidar_radar': dict(kernels=TRAINER_KERNELS, eval_argv=['--config', 'eval_lidar_radar',
                                                           'eval_split=None'], never=()),
    'lidar_cam_radar': dict(kernels=CAMERA_TRAIN_KERNELS, eval_argv=['--config', 'lidar_cam_radar'],
                            never=('voxelize_pillars_dense', 'deform_sample', 'lift_splat',
                                   'lift_splat_backward', 'depth_grid_to_onehot')),
}


def _loader_rate(root, cfg):
    """Samples/s of the port's loader alone at B=4 with 8 thread workers:
    (second pass, first pass); the first builds the host libraries and the
    remap tables and warms the page cache."""
    from mm_training_tpu_torch.data import AiMotiveDataset
    from mm_training_tpu_torch.training.loader import PrefetchLoader
    loader = PrefetchLoader(AiMotiveDataset(root, cfg, 'train'), 4, num_workers=8)
    try:
        rates = []
        for _ in range(2):
            t0 = time.perf_counter()
            n = sum(b['points'].shape[0] for b in loader)
            rates.append(n / (time.perf_counter() - t0))
    finally:
        loader.close()
    return rates[1], rates[0], n


def write_tree(root, fisheye_root):
    """Phases 20 and 24: an aiMotive tree written by the port's writer, LAZ
    frames of ~100k points and 704 x 1280 front and back JPEGs of the
    writer's ``image_detail`` (its own encoder, quality 85): train 16
    frames, val 8 (seeds of their own, so no val frame repeats a train
    frame); and a second tree of 8 train frames with the two fisheyes too.
    Then the port's loader alone at B=4 with 8 thread workers: for
    ``lidar_radar`` (no image decoded) and ``lidar_cam_radar`` (2 cameras)
    on the first tree, ``lidar_cam_radar`` with the fisheyes virtualized (6
    cameras) on the second."""
    from mm_training_tpu_torch.configs import lidar_cam_radar, lidar_radar
    from mm_training_tpu_torch.data import generate_synthetic_dataset

    t0 = time.perf_counter()
    for i, (split, n) in enumerate(TREE_FRAMES.items()):
        generate_synthetic_dataset(root, splits=(split,), frames_per_sequence=n,
                                   n_objects=12, seed=SEED + 40 + i, image_detail=True,
                                   n_ground_points=100_000, lidar_format='laz')
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    generate_synthetic_dataset(fisheye_root, splits=('train',),
                               frames_per_sequence=FISHEYE_TRAIN_FRAMES, n_objects=12,
                               seed=SEED + 42, image_detail=True, fisheyes=True,
                               n_ground_points=100_000, lidar_format='laz')
    fish_write_s = time.perf_counter() - t0
    jpegs = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith('.jpg')]
    jpeg_mb = sum(os.path.getsize(f) for f in jpegs) / len(jpegs) / 1e6
    stats = {'write_s': write_s, 'fisheye_write_s': fish_write_s, 'jpeg_mb_each': jpeg_mb}
    for key, tree, cfg in (('loader', root, lidar_radar()),
                           ('camera_loader', root, lidar_cam_radar()),
                           ('fisheye_loader', fisheye_root,
                            lidar_cam_radar(virtualize_fisheyes=True, num_cameras=6))):
        rate, first, n = _loader_rate(tree, cfg)
        expect = FISHEYE_TRAIN_FRAMES if tree == fisheye_root else TREE_FRAMES['train']
        if n != expect:
            raise AssertionError(f'the {key} yielded {n} train samples')
        stats[f'{key}_samples_per_s'] = rate
        stats[f'{key}_first_pass_samples_per_s'] = first
    print(f'tree: {TREE_FRAMES} frames (LAZ + 2 JPEGs of {jpeg_mb:.3f} MB each) written in '
          f'{write_s:.3f} s, the fisheye tree ({FISHEYE_TRAIN_FRAMES} frames, 4 JPEGs each) in '
          f'{fish_write_s:.3f} s; the loader alone (B=4, 8 thread workers), samples/s of a '
          f'second pass: lidar_radar {stats["loader_samples_per_s"]:.3f}, lidar_cam_radar '
          f'{stats["camera_loader_samples_per_s"]:.3f}, with the fisheyes virtualized '
          f'{stats["fisheye_loader_samples_per_s"]:.3f} (first passes '
          f'{stats["loader_first_pass_samples_per_s"]:.3f}, '
          f'{stats["camera_loader_first_pass_samples_per_s"]:.3f}, '
          f'{stats["fisheye_loader_first_pass_samples_per_s"]:.3f})', flush=True)
    return stats


def write_depth_grids(root, out, cfg):
    """The depth-GT mirror tree of ``depth_gt_root``: for each keyframe of
    ``root``, the min depth of its own aggregated LiDAR points in each
    virtual camera's 16 x 16 cells (0 where no point lands), computed by the
    port's ``ops/depth_labels.py::min_depth_grid_plain`` on the card, saved
    as ``<out>/<frame path without extension>_depth.npy`` [N, fH, fW]
    float32 (the layout the JAX package's scripts/gen_depth_gt.py writes).
    Returns (the share of non-empty cells, the cameras a frame)."""
    import os
    from mm_training_tpu_torch.data import FrameLoader, get_frames
    from mm_training_tpu_torch.ops.depth_labels import EMPTY, min_depth_grid_plain

    loader = FrameLoader('train', (-1e9, -1e9, -1e9, 1e9, 1e9, 1e9), use_cam=True,
                         use_lidar=True, use_radar=False, image_size=cfg.final_dim)
    filled = []
    for split in TREE_FRAMES:
        for path in get_frames(root, split):
            frame = loader[path]
            pts = torch.as_tensor(frame.points[None, :, :3], device='cuda')
            ext = torch.as_tensor(np.stack([c.camera_params.extrinsic for c in frame.cameras])[
                None], dtype=torch.float32, device='cuda')
            intr = np.tile(np.eye(4, dtype=np.float32), (len(frame.cameras), 1, 1))
            intr[:, :3, :4] = [c.camera_params.intrinsic[:3, :4] for c in frame.cameras]
            grid = min_depth_grid_plain(pts, torch.ones(pts.shape[:2], dtype=torch.bool,
                                                        device='cuda'), ext,
                                        torch.as_tensor(intr[None], device='cuda'),
                                        cfg.final_dim, 16)
            grid = torch.where(grid >= EMPTY, 0.0, grid).reshape(
                len(frame.cameras), cfg.final_dim[0] // 16, cfg.final_dim[1] // 16)
            rel = os.path.relpath(path, root)
            file = os.path.join(out, os.path.splitext(rel)[0] + '_depth.npy')
            os.makedirs(os.path.dirname(file), exist_ok=True)
            np.save(file, grid.cpu().numpy())
            filled.append(float((grid > 0).float().mean()))
    return float(np.mean(filled)), len(frame.cameras)


def trainer_child(root, out, result_file, config='lidar_radar'):
    """Phases 21-23 (``config`` lidar_radar) or 25-28 (lidar_cam_radar) in a
    process of their own (a fresh profiler and a fresh memory pool): train
    the full-width ``config`` through ``exps.train`` (B=4, 12 steps from the
    tree: a sanity val, a 'latest' every 4 steps, a val each 4-step epoch,
    the test pass on 'best'), every kernel's launch count reset before and
    read after and every plain version counted; one more epoch under
    torch.profiler for the device's busy share; then ``exps.evaluate`` on
    'best'; with the camera, 2 steps of ``exps.train`` with
    ``depth_gt_root`` on grids this process writes
    (:func:`write_depth_grids`), counted the same way; and the imports
    check. Writes its numbers to ``result_file``."""
    import glob
    import os
    from torch.profiler import ProfilerActivity, profile

    from mm_training_tpu_torch.configs import CLASSES, variants
    from mm_training_tpu_torch.data.formats import object_to_array
    from mm_training_tpu_torch.exps import evaluate, train
    from mm_training_tpu_torch.training.trainer import Trainer

    run = TRAINER_RUNS[config]
    camera = config != 'lidar_radar'

    def counted_train(argv, label):
        metrics, counts, wall_s = _counted_entry(train.main, argv, f'trainer {label}')
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f'non-finite test metrics {metrics}')
        return metrics, counts, wall_s

    train_out = os.path.join(out, 'train')
    metrics, counts, wall_s = counted_train(
        ['--config', config, '--data-root', root, '--max-steps', '12', 'batch_size=4',
         'num_workers=8', f'out_path={train_out!r}', 'num_sanity_val_steps=1',
         'latest_every_n_steps=4', f'seed={SEED + 50}'], config)
    records = [json.loads(line) for line in open(os.path.join(train_out, 'metrics.jsonl'))]
    step_p50 = [r['step_time_p50'] for r in records if 'step_time_p50' in r][-1]
    vals = [r for r in records if 'val_detection_loss' in r]
    val_rows = [(r['step'], r['val_detection_loss'], r['val_ap_auc']) for r in vals]
    saved = {name: sorted(os.listdir(os.path.join(train_out, 'saved_models', name)))
             for name in ('best', 'latest')}
    print(f'trainer: exps.train {config} B=4, 12 steps from the tree in {wall_s:.3f} s '
          f'(sanity val, 3 vals, test pass); step p50 {step_p50 * 1e3:.3f} ms (StepTimer); '
          f'vals {json.dumps(val_rows)}'
          f'; saved {json.dumps(saved)}', flush=True)
    missing = [n for n in run['kernels'] if counts[n] == 0]
    if missing:
        raise AssertionError(f'kernels never launched on the {config} trainer path: {missing}')
    launched = [n for n in run['never'] if counts[n]]
    if launched:
        raise AssertionError(f'the {config} trainer path launched {launched}')
    epochs = 12 // (TREE_FRAMES['train'] // 4)
    if len(vals) != epochs or not all(np.isfinite([r['val_detection_loss'], r['val_ap_auc']]).all()
                                      for r in vals):
        raise AssertionError(f'expected {epochs} finite val passes: {vals}')
    if saved['latest'] != ['12'] or not saved['best']:
        raise AssertionError(f'checkpoints: {saved}')

    # the device's busy share of one more epoch (4 steps and a val pass)
    factory = getattr(variants, config)
    tr = Trainer(factory(batch_size=4, num_workers=8, num_sanity_val_steps=0,
                         out_path=os.path.join(out, 'profiled'), seed=SEED + 51),
                 data_root=root)
    try:
        tr.setup()
        tr.init_state(next(iter(tr.loader('train'))))
        tr.fit(max_epochs=1)       # warm: the first epoch's allocations and cuDNN plans
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.fit(max_epochs=2)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        tr.close()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == 'CUDA' and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    busy = busy_ms / prof_wall_ms
    print(f'trainer {config}: one profiled epoch (4 steps, a val pass of 8 frames): wall '
          f'{prof_wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, busy share {busy:.4f}',
          flush=True)
    if busy_ms <= 0:
        raise AssertionError('the profiled trainer epoch recorded no device time')

    best = os.path.join(train_out, 'saved_models', 'best')
    recorded = {}
    for d in os.listdir(best):
        with open(os.path.join(best, d, 'metrics.json')) as f:
            recorded[int(d)] = json.load(f)['val_detection_loss']
    best_step = min(recorded, key=lambda d: (recorded[d], -d))
    eval_out = os.path.join(out, 'eval')
    ev = evaluate.main(run['eval_argv'][:2] + ['--data-root', root] + run['eval_argv'][2:]
                       + [f'ckpt_path={best!r}', 'batch_size=4', 'num_workers=8',
                          f'out_path={eval_out!r}'])
    rel = abs(ev['test_detection_loss'] - recorded[best_step]) / abs(recorded[best_step])
    files = sorted(glob.glob(os.path.join(eval_out, 'outputs', '**', '*.json'), recursive=True))
    parsed = []
    for file in files:
        for obj in json.load(open(file))['CapturedObjects']:
            arr, name = object_to_array(obj)
            if not (np.isfinite(arr).all() and name in CLASSES and 0 <= obj['Score'] <= 1):
                raise AssertionError(f'bad exported box in {file}: {obj}')
            parsed.append(arr)
    print(f'evaluate {config}: best step {best_step} (recorded val_detection_loss '
          f'{recorded[best_step]:.6f}, of {json.dumps(recorded)}); test_detection_loss '
          f'{ev["test_detection_loss"]:.6f}, relative difference {rel:.3e}; test_ap_auc '
          f'{ev["test_ap_auc"]:.6f}; {len(files)} JSON files, {len(parsed)} boxes parsed back',
          flush=True)
    if rel > 1e-4:
        raise AssertionError('exps.evaluate does not reproduce the recorded val loss')
    if len(files) != TREE_FRAMES['val'] or len(parsed) < ev['test_num_preds']:
        raise AssertionError(f'export: {len(files)} files, {len(parsed)} boxes, '
                             f'{ev["test_num_preds"]} predictions')
    result = {'counts': counts, 'step_p50_ms': step_p50 * 1e3, 'wall_s': wall_s,
              'busy_share': busy, 'profiled_wall_ms': prof_wall_ms,
              'busy_ms': busy_ms, 'eval_rel': rel, 'best_step': best_step}

    if camera:
        grids = os.path.join(out, 'depth_gt')
        t0 = time.perf_counter()
        # one grid a camera of the frame: num_cameras must say as many
        # (the JAX dataset refuses fewer grids than num_cameras)
        filled, n_cams = write_depth_grids(root, grids, factory())
        grid_s = time.perf_counter() - t0
        print(f'depth_gt: grids of {sum(TREE_FRAMES.values())} frames x {n_cams} cameras written '
              f'in {grid_s:.3f} s (the min depth of each frame\'s own points, '
              f'ops/depth_labels.py::min_depth_grid_plain); {filled:.4f} of the cells hold a '
              'depth', flush=True)
        gt_metrics, gt_counts, gt_wall_s = counted_train(
            ['--config', config, '--data-root', root, '--max-steps', '2', '--max-batches', '1',
             'batch_size=4', 'num_workers=8', f'out_path={os.path.join(out, "depth_gt_run")!r}',
             'num_sanity_val_steps=0', f'depth_gt_root={grids!r}', f'num_cameras={n_cams}',
             f'seed={SEED + 52}'],
            f'{config} depth_gt_root')
        print(f'trainer {config} depth_gt_root: 2 steps, a val pass and a test batch in '
              f'{gt_wall_s:.3f} s; test_depth_loss {gt_metrics["test_depth_loss"]:.4f}',
              flush=True)
        if gt_counts['depth_grid_to_onehot'] == 0 or gt_counts['depth_labels']:
            raise AssertionError(f'depth_gt_root: K6 binning {gt_counts["depth_grid_to_onehot"]}'
                                 f' launches, projection {gt_counts["depth_labels"]}')
        result.update(depth_gt_counts=gt_counts, depth_gt_wall_s=gt_wall_s,
                      depth_gt_filled=filled)
    leaked = [m for m in ('cv2', 'PIL', 'jax', 'mm_training_tpu') if m in sys.modules]
    if leaked:
        raise AssertionError(f'the trainer path imported {leaked}')
    with open(result_file, 'w') as f:
        json.dump(result, f)


def run_trainer(root, config='lidar_radar'):
    """:func:`trainer_child` in a child interpreter."""
    import os
    import tempfile
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        result_file = os.path.join(out, 'result.json')
        code = (f'import chip_smoke; chip_smoke.trainer_child({root!r}, {out!r}, '
                f'{result_file!r}, {config!r})')
        proc = subprocess.run([sys.executable, '-c', code], timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f'the {config} trainer phases failed ({proc.returncode})')
        with open(result_file) as f:
            return json.load(f)


# --- phases 29-33: the eval and serving runtime (EMA, TTA, BN folding, the
# trainer's predict, profile and viz panels)

TTA_PER_REQUEST = {'pillar_encoder_input': 4, 'lift_splat_factorized': 4, 'deform_conv3x3': 4,
                   'bda_bev_warp': 4, 'depth_labels': 1, 'circle_nms_mask': 1}


def _alternating_p50(calls, samples, rounds=6):
    """{label: (p50 ms, p90 ms)} of ``calls`` ({label: fn() -> outputs on the
    card}) on the host clock, each call ending in a host read of its
    outputs, taken in ``rounds`` alternating rounds of ``samples // rounds``
    calls each (PERF.md section 7: two p50s only from one process, in turns)."""
    lat = {k: [] for k in calls}
    per = max(1, samples // rounds)
    for r in range(rounds):
        order = list(calls) if r % 2 == 0 else list(calls)[::-1]
        for label in order:
            for _ in range(per):
                t0 = time.perf_counter()
                [o.cpu() for o in calls[label]()]
                lat[label].append((time.perf_counter() - t0) * 1e3)
    return {k: (float(np.percentile(v, 50)), float(np.percentile(v, 90)), len(v))
            for k, v in lat.items()}


def _request_peak_gib(fn):
    """(peak GiB of one call above what is held before it, held GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 30
    [o.cpu() for o in fn()]
    return torch.cuda.max_memory_allocated() / 2 ** 30 - base, base


def _map_rel_diff(got, want):
    return max(((g[k].float() - w[k].float()).abs().max()
                / w[k].float().abs().max().clamp_min(1.0)).item()
               for g, w in zip(got, want) for k in w)


def _box_match(ref, got, tol, slots=83):
    """(share of ``ref``'s kept boxes that ``got`` keeps with the same label,
    a score within ``tol`` and its BEV centre within 0.5 m, the boxes a
    task's top-k cut may trade excepted; the worst centre distance among
    the matched, in m; the boxes counted)."""
    (rb, rs, rl, rv), (gb, gs, gl, gv) = ([o.numpy() for o in x] for x in (ref, got))
    matched, n, worst = 0, 0, 0.0
    for b, i in zip(*np.nonzero(rv)):
        block = slice(i // slots * slots, (i // slots + 1) * slots)
        dist = np.abs(gb[b, :, :2] - rb[b, i, :2]).max(-1)
        same = gv[b] & (gl[b] == rl[b, i]) & (np.abs(gs[b] - rs[b, i]) <= tol) & (dist <= 0.5)
        if same.any():
            matched += 1
            worst = max(worst, float(dist[same].min()))
        elif rs[b, i] - rs[b, block][rv[b, block]].min() <= tol:
            continue            # at the cut: may be kept on one side only
        n += 1
    return matched / max(n, 1), worst, n


def serve_tta_and_folded(cfg, samples):
    """Phases 29 and 30 for one full-width model at B=1 (``lidar_radar`` or
    ``lidar_cam_radar``; bf16, seeded random weights and BN statistics).

    29: a ``use_tta`` request through ``make_predict_step``: the launches of
    one request (K1, K4, K5, K7 four times, K6 and K3 once, A four times the
    plain request's), no plain version called; its ensembled pred maps
    through the kernels against the plain versions (bf16, 1/32 of the map's
    scale, as phase 4a) and finite boxes; TTA and plain p50 in alternating
    rounds and each request's peak memory.
    30: the same model folded (``fold_model``): the same A launches a request,
    each with a unit scale, no plain version called; its pred maps against
    the unfolded model's (bf16, 1/32); in fp32 (TF32 off) every box of the
    unfolded model kept by the folded one with the same label, a score
    within 2e-3 and the centre within 0.5 m; folded and unfolded p50 in
    alternating rounds."""
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.models.bn_fold import FoldedBN, fold_model
    from mm_training_tpu_torch.training import (camera_inputs, cast_floating,
                                                make_predict_step)
    from mm_training_tpu_torch.training.tta import tta_forward

    camera = cfg.use_cam
    label = cfg.experiment_name
    gen = torch.Generator().manual_seed(SEED + 60)
    model = BEVDepthLiDAR(cfg, device='cuda', generator=gen)
    _randomize_bn(model, gen)
    if camera:
        _randomize_offsets(model, gen)
    plain = make_predict_step(cfg, model)
    tta = make_predict_step(cfg.replace(use_tta=True), model)
    request = make_fake_batch(cfg, batch_size=1, seed=SEED + 61)
    result = {}

    # --- phase 29: TTA
    per = {}
    for kind, fn in (('plain', plain), ('tta', tta)):
        [o.cpu() for o in fn(request)]                      # warm
        out, per[kind], plain_calls, _ = _counted(lambda: [o.cpu() for o in fn(request)])
        if plain_calls:
            raise AssertionError(f'the {kind} {label} request called plain versions {plain_calls}')
        boxes, scores, _, valid = out
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all() and valid.any()):
            raise AssertionError(f'{kind} {label} request: non-finite or no boxes')
    expect = {n: c for n, c in TTA_PER_REQUEST.items()
              if camera or n in ('pillar_encoder_input', 'circle_nms_mask')}
    wrong = {n: per['tta'][n] for n, c in expect.items() if per['tta'][n] != c}
    if wrong or per['tta']['affine_act'] != 4 * per['plain']['affine_act']:
        raise AssertionError(f'TTA {label} launches a request {per["tta"]} (plain '
                             f'{per["plain"]}): expected {expect} and A 4x')
    net = cast_floating(model, torch.bfloat16)
    pts = torch.as_tensor(request['points'], device='cuda')
    mask = torch.as_tensor(request['point_mask'], device='cuda')
    with torch.inference_mode():
        cam = camera_inputs(cfg, request, 'cuda', pts, mask) if camera else {}
        got, _ = tta_forward(net, None, pts, mask, cam, return_depth=False)
        before = {n: w.launches for n, w in _wrappers().items()}
        with _plain_versions():
            want, _ = tta_forward(net, None, pts, mask, cam, return_depth=False)
        if {n: w.launches for n, w in _wrappers().items()} != before:
            raise AssertionError('the plain TTA run launched a kernel')
    del net
    tta_vs_plain = _map_rel_diff(got, want)
    if not tta_vs_plain <= 1 / 32:
        raise AssertionError(f'TTA {label} pred maps: kernels vs plain {tta_vs_plain}')
    peak = {k: _request_peak_gib(lambda: fn(request)) for k, fn in (('plain', plain), ('tta', tta))}
    p50 = _alternating_p50({'plain': lambda: plain(request), 'tta': lambda: tta(request)}, samples)
    print(f'TTA {label} B=1: launches a request {json.dumps({n: c for n, c in per["tta"].items() if c})}'
          f' (plain: {json.dumps({n: c for n, c in per["plain"].items() if c})}); pred maps '
          f'kernels vs plain {tta_vs_plain:.4g}; p50/p90 ms TTA {p50["tta"][0]:.3f}/'
          f'{p50["tta"][1]:.3f}, plain {p50["plain"][0]:.3f}/{p50["plain"][1]:.3f} ({p50["tta"][2]}'
          f' samples each, alternating rounds); peak GiB of a request above the held '
          f'{peak["tta"][1]:.4f}: TTA {peak["tta"][0]:.4f}, plain {peak["plain"][0]:.4f}',
          flush=True)
    result['tta'] = {'launches_tta': per['tta'], 'launches_plain': per['plain'],
                     'p50_ms': p50['tta'][0], 'p90_ms': p50['tta'][1],
                     'plain_p50_ms': p50['plain'][0], 'plain_p90_ms': p50['plain'][1],
                     'samples': p50['tta'][2], 'peak_above_held_gib': peak['tta'][0],
                     'plain_peak_above_held_gib': peak['plain'][0],
                     'maps_vs_plain_versions': tta_vs_plain}

    # --- phase 30: the folded model
    folded = copy.deepcopy(model)
    pairs = fold_model(folded)
    n_folded = sum(isinstance(m, FoldedBN) for m in folded.modules())
    folded_step = make_predict_step(cfg, folded)
    [o.cpu() for o in folded_step(request)]
    scales = []
    folded_forward = FoldedBN.forward

    def recording(bn, *a, **k):      # the scale each folded tail hands to kernel A
        scales.append(bn.scale_shift()[0])
        return folded_forward(bn, *a, **k)
    with mock.patch.object(FoldedBN, 'forward', recording):
        fold_out, fold_counts, plain_calls, _ = _counted(
            lambda: [o.cpu() for o in folded_step(request)])
    unit = bool(torch.stack([s.eq(1).all() for s in scales]).all())
    if plain_calls or fold_counts['affine_act'] != per['plain']['affine_act'] or not unit \
            or len(scales) != fold_counts['affine_act']:
        raise AssertionError(f'folded {label}: A launches {fold_counts["affine_act"]} (unfolded '
                             f'{per["plain"]["affine_act"]}), unit scales {unit}, plain '
                             f'versions {plain_calls}')
    nets = [cast_floating(m, torch.bfloat16) for m in (model, folded)]
    with torch.inference_mode():
        ref_maps, fold_maps = (net(pts, mask, **cam) for net in nets)
    del nets
    fold_vs_unfolded = _map_rel_diff(fold_maps, ref_maps)
    bf16_share, _, _ = _box_match([o.cpu() for o in plain(request)], fold_out, 2e-3)
    # the boxes in fp32 (TF32 off), as the JAX CLI test compares them: in
    # bf16 the fold rounds W * s where the unfolded model rounds W, which
    # moves some scores of these random weights by more than 2e-3
    fp32 = cfg.replace(precision='fp32')
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        share, worst, n_boxes = _box_match(
            *([o.cpu() for o in make_predict_step(fp32, m)(request)] for m in (model, folded)),
            2e-3)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    if not (fold_vs_unfolded <= 1 / 32 and share == 1.0):
        raise AssertionError(f'folded {label} pred maps differ from the unfolded by '
                             f'{fold_vs_unfolded}; {share} of the fp32 boxes kept')
    p50f = _alternating_p50({'unfolded': lambda: plain(request),
                             'folded': lambda: folded_step(request)}, samples)
    print(f'folded {label} B=1: {len(pairs)} conv+BN pairs folded, {n_folded} FoldedBN, A '
          f'{fold_counts["affine_act"]} launches a request (unfolded '
          f'{per["plain"]["affine_act"]}), every scale 1; pred maps vs unfolded '
          f'{fold_vs_unfolded:.4g} (bf16); in fp32 {share:.4f} of {n_boxes} kept boxes kept '
          f'with the same label, a score within 2e-3 and the centre within 0.5 m (worst '
          f'{worst:.4g} m; bf16: {bf16_share:.4f}); p50/p90 ms folded '
          f'{p50f["folded"][0]:.3f}/{p50f["folded"][1]:.3f}, unfolded {p50f["unfolded"][0]:.3f}/'
          f'{p50f["unfolded"][1]:.3f} ({p50f["folded"][2]} samples each, alternating rounds)',
          flush=True)
    result['folded'] = {'launches': fold_counts, 'p50_ms': p50f['folded'][0],
                        'p90_ms': p50f['folded'][1], 'unfolded_p50_ms': p50f['unfolded'][0],
                        'unfolded_p90_ms': p50f['unfolded'][1], 'pairs': len(pairs),
                        'maps_vs_unfolded': fold_vs_unfolded, 'fp32_box_share_2e-3': share,
                        'bf16_box_share_2e-3': bf16_share, 'boxes': n_boxes}
    del model, folded, plain, tta, folded_step
    torch.cuda.empty_cache()
    return result


def train_ema(cfg, steps=5):
    """Phase 31: full-width ``lidar_cam_radar`` at B=4 with ``use_ema``: 2
    warm-up and ``steps`` timed steps with the EMA update, in turns with as
    many steps without it on the same state (bf16 compute, the fixed fake
    batch of phase 11); both step p50s and peak memories, the EMA update's
    device ms; the shadow after each of the last two EMA steps held to a
    host recomputation of ``ema_update`` from the shadow before the step and
    the float32 masters and statistics after it (the same bits)."""
    from mm_training_tpu_torch.exps.profile_train import train_batch
    from mm_training_tpu_torch.exps.timing import device_ms
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.training import create_train_state, make_train_step
    from mm_training_tpu_torch.training.ema import ema_update

    cfg = cfg.replace(batch_size=4, use_ema=True)
    model = BEVDepthLiDAR(cfg, device='cuda', generator=torch.Generator().manual_seed(SEED + 70))
    state = create_train_state(cfg, model)
    steps_of = {'ema': make_train_step(cfg), 'plain': make_train_step(cfg.replace(use_ema=False))}
    batch = train_batch(cfg, SEED + 71)
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    for _ in range(2):
        for fn in steps_of.values():
            state, m = fn(state, batch)
    float(m['train_loss'])
    lat = {k: [] for k in steps_of}
    peak = {k: 0.0 for k in steps_of}
    worst, checked = 0, 0
    for i in range(steps):
        for kind, fn in steps_of.items():
            check = kind == 'ema' and i >= steps - 2
            if check:
                prev = {k: v.detach().cpu().clone() for k, v in state.ema.items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, m = fn(state, batch)
            torch.cuda.synchronize()
            lat[kind].append((time.perf_counter() - t0) * 1e3)
            peak[kind] = max(peak[kind], torch.cuda.max_memory_allocated() / 2 ** 30)
            if not np.isfinite(float(m['train_loss'])):
                raise AssertionError(f'non-finite {kind} train loss')
            if check:
                stored = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
                want = ema_update(prev, stored, state.step, cfg.ema_decay)
                for k, t in state.ema.items():
                    got = t.cpu()
                    if got.is_floating_point():
                        worst = max(worst, int((got != want[k]).sum()))
                    elif not torch.equal(got, want[k]):
                        worst = max(worst, int((got != want[k]).sum()))
                checked += 1
    counts = {n: w.launches for n, w in wrappers.items()}
    shadow = {k: v.clone() for k, v in state.ema.items()}
    masters = state.model.state_dict()
    ema_ms = device_ms(lambda: ema_update(shadow, masters, 1000, cfg.ema_decay), 20)
    n_floats = sum(v.numel() for v in shadow.values() if v.is_floating_point())
    bound_ms = 3 * 4 * n_floats / HBM_BYTES_PER_S * 1e3
    p50 = {k: float(np.percentile(v, 50)) for k, v in lat.items()}
    print(f'EMA training lidar_cam_radar B=4: step p50 with the EMA update {p50["ema"]:.3f} ms, '
          f'without {p50["plain"]:.3f} ms ({steps} steps each, in turns after 2 warm-up each); '
          f'peak device memory {peak["ema"]:.4f} / {peak["plain"]:.4f} GiB; the EMA update '
          f'alone {ema_ms:.4f} ms of device time over {n_floats} float32 entries (bound '
          f'{bound_ms:.4f} ms: two reads and one write at the HBM rate); shadow vs host '
          f'ema_update after the last {checked} EMA steps: {worst} entries differ; launches '
          f'{json.dumps({n: c for n, c in counts.items() if c})}', flush=True)
    if worst or checked != 2:
        raise AssertionError(f'the EMA shadow differs from ema_update in {worst} entries')
    del state, model, shadow, masters
    torch.cuda.empty_cache()
    return {'p50_ms': p50['ema'], 'plain_p50_ms': p50['plain'], 'peak_gib': peak['ema'],
            'plain_peak_gib': peak['plain'], 'ema_update_ms': ema_ms,
            'ema_update_bound_ms': bound_ms, 'counts': counts, 'steps': 2 * (steps + 2)}


def _png_checks(panels, cfg):
    """Each panel PNG's IHDR against the panel's size, its IDAT inflated
    with zlib to its rows (filter byte 0 and 3 bytes a pixel: the rendered
    BGR panel stored as RGB), content drawn. Returns {kind: (h, w)}."""
    import zlib
    bb, head = cfg.get_backbone_conf(), cfg.get_head_conf()
    pc = cfg.point_cloud_range
    hh, hw = (n // cfg.out_size_factor for n in cfg.out_shape)
    sizes = {'bev': (round((pc[4] - pc[1]) * 2), round((pc[3] - pc[0]) * 2)),
             'heatmaps': (hh, len(head.tasks) * (hw + 2)), 'depth': tuple(bb.feat_hw),
             'cam0': tuple(cfg.final_dim)}
    seen = {}
    for kind, (h, w) in sizes.items():
        files = sorted(f for f in os.listdir(panels) if f.split('_')[1] == kind)
        if not files:
            raise AssertionError(f'no {kind} panel under {panels}')
        for name in files:
            data = open(os.path.join(panels, name), 'rb').read()
            chunks, pos = {}, 8
            while pos < len(data):
                n = int.from_bytes(data[pos:pos + 4], 'big')
                kind_ = data[pos + 4:pos + 8].decode()
                chunks.setdefault(kind_, b'')
                chunks[kind_] += data[pos + 8:pos + 8 + n]
                pos += 12 + n
            ih = chunks['IHDR']
            size = (int.from_bytes(ih[4:8], 'big'), int.from_bytes(ih[0:4], 'big'))
            raw = np.frombuffer(zlib.decompress(chunks['IDAT']), np.uint8)
            if size != (h, w) or ih[8:10] != b'\x08\x02' or raw.size != h * (1 + 3 * w):
                raise AssertionError(f'{name}: IHDR {size} {ih[8:10]!r}, {raw.size} bytes, '
                                     f'expected {(h, w)}')
            rows = raw.reshape(h, 1 + 3 * w)
            if rows[:, 0].any() or rows[:, 1:].max() == rows[:, 1:].min():
                raise AssertionError(f'{name}: a filter byte set or nothing drawn')
        seen[kind] = (h, w, len(files))
    return seen


def _counted(fn):
    """(``fn()``, every kernel wrapper's launches during it, the calls of
    each plain version during it, its wall seconds ending in a
    synchronize): the launch counts reset before and read after."""
    plain_calls = {}
    wrappers = _wrappers()

    def counting(name, plain):
        def call(*args, **kw):
            plain_calls[name] = plain_calls.get(name, 0) + 1
            return plain(*args, **kw)
        return call
    with contextlib.ExitStack() as stack:
        for mod, name, plain in _swaps():
            stack.enter_context(mock.patch.object(mod, plain.__name__, counting(name, plain)))
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {n: w.launches for n, w in wrappers.items()}
    return out, counts, plain_calls, wall_s


def _counted_entry(fn, argv, label):
    """``fn(argv)`` (an exps entry point) through :func:`_counted`, printed;
    raises when a plain version was called."""
    out, counts, plain_calls, wall_s = _counted(lambda: fn(argv))
    print(f'{label}: launches {json.dumps({n: c for n, c in counts.items() if c})}; plain '
          f'versions called {json.dumps(plain_calls)}; {wall_s:.3f} s', flush=True)
    if plain_calls:
        raise AssertionError(f'{label} called plain versions: {plain_calls}')
    return out, counts, wall_s


TRACE_KERNELS = {'affine_act': 'affine_act_kernel', 'affine_act_backward': 'affine_act_bwd_kernel',
                 'pillar_encoder_input': 'pillar_kernel',
                 'lift_splat_factorized': 'lift_splat_kernel',
                 'deform_conv3x3': 'deform_conv_kernel'}


def runtime_child(root, out, result_file):
    """Phases 32-33 in a process of their own: ``exps.train`` on full-width
    ``lidar_cam_radar`` with ``use_ema``, ``use_tta`` and
    ``viz_every_n_steps=2`` (B=4, 4 steps from the tree: a sanity val batch,
    a val pass, the test pass on 'best'); every kernel of phase 25 launched,
    the eval kernels four times an eval batch (K6 and K3 once), no plain
    version called; the BEV, heatmap, depth and cam0 PNGs and the .ply
    written (:func:`_png_checks`). Then ``exps.train --profile`` in a child
    interpreter (retried up to three times while its trace holds no device
    event): a trace.json that parses and holds the kernels of A, A', K1, K4
    and K5. Then ``exps.inference`` on 'best' (EMA weights, fp32, TF32 off)
    with and without ``--fold-bn``: one JSON a val frame, the folded boxes
    those of the unfolded by label and score within 2e-3. Then
    ``exps.evaluate`` on 'best' with EMA and TTA: the recorded val loss
    within 1e-4 relative. Last, no cv2, PIL, jax or mm_training_tpu
    imported."""
    import glob
    from mm_training_tpu_torch.configs import CLASSES, lidar_cam_radar
    from mm_training_tpu_torch.data.formats import object_to_array
    from mm_training_tpu_torch.exps import evaluate, inference, train

    cfg = lidar_cam_radar()
    train_out = os.path.join(out, 'train')
    flags = ['use_ema=True', 'use_tta=True']
    metrics, counts, wall_s = _counted_entry(train.main, [
        '--config', 'lidar_cam_radar', '--data-root', root, '--max-steps', '4', 'batch_size=4',
        'num_workers=8', f'out_path={train_out!r}', 'num_sanity_val_steps=1',
        'viz_every_n_steps=2', f'seed={SEED + 80}'] + flags, 'runtime exps.train (EMA, TTA, viz)')
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f'non-finite test metrics {metrics}')
    steps, evals = 4, counts['circle_nms_mask']
    want = {n: steps for n in ('lift_splat_factorized_backward', 'deform_conv3x3_backward',
                               'warp_backward')}
    want.update({n: steps + 4 * evals for n in ('pillar_encoder_input', 'lift_splat_factorized',
                                                 'deform_conv3x3', 'bda_bev_warp')})
    want['depth_labels'] = steps + evals
    wrong = {n: counts[n] for n, c in want.items() if counts[n] != c}
    missing = [n for n in CAMERA_TRAIN_KERNELS if counts[n] == 0]
    # a sanity val batch, a val pass of 2 batches, 2 train-batch panels, a
    # test pass of 2 batches
    if wrong or missing or evals != 7:
        raise AssertionError(f'runtime launches {counts}: expected {want} with 7 eval batches, '
                             f'missing {missing}')
    panels = _png_checks(os.path.join(train_out, 'panels'), cfg)
    scenes = sorted(os.listdir(os.path.join(train_out, 'scenes')))
    plys = [f for f in scenes if f.endswith('.ply')]
    if not plys or not all(os.path.getsize(os.path.join(train_out, 'scenes', f)) > 1000
                           for f in plys):
        raise AssertionError(f'scenes: {scenes}')
    print(f'runtime panels (h, w, files): {json.dumps(panels)}; scenes {len(plys)} .ply',
          flush=True)

    # exps.train --profile in a fresh interpreter (a profiler session of a
    # process that has run many kernels may record no device event)
    import mm_training_tpu_torch
    root_of_package = os.path.dirname(os.path.dirname(os.path.abspath(
        mm_training_tpu_torch.__file__)))
    found, tries = {}, 0
    for tries in range(1, 4):
        prof_out = os.path.join(out, f'profile{tries}')
        proc = subprocess.run([sys.executable, '-m', 'mm_training_tpu_torch.exps.train',
                               '--profile', '--config', 'lidar_cam_radar', '--data-root', root,
                               '--max-steps', '3', 'batch_size=4', 'num_workers=8',
                               f'out_path={prof_out!r}'], capture_output=True, text=True,
                              timeout=600, cwd=root_of_package)
        if proc.returncode != 0:
            raise AssertionError(f'exps.train --profile failed:\n{proc.stderr[-3000:]}')
        with open(os.path.join(prof_out, 'profile', 'trace.json')) as f:
            trace = json.load(f)
        kernels = [e['name'] for e in trace['traceEvents'] if e.get('cat') == 'kernel']
        found = {k: sum(sub in n for n in kernels) for k, sub in TRACE_KERNELS.items()}
        if kernels:
            break
    print(f'exps.train --profile: {len(trace["traceEvents"])} trace events, {len(kernels)} '
          f'kernel events after {tries} session(s); port kernels {json.dumps(found)}',
          flush=True)
    if not all(found.values()):
        raise AssertionError(f'the profile trace lacks port kernels: {found}')

    best = os.path.join(train_out, 'saved_models', 'best')
    torch.backends.cudnn.allow_tf32 = False        # fp32 comparison: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    exported = {}
    for fold in (False, True):
        dst = os.path.join(out, f'inference_fold{int(fold)}')
        _counted_entry(inference.main, ['--fold-bn'] * fold + [
            '--config', 'lidar_cam_radar', '--data-root', root, f'ckpt_path={best!r}',
            'batch_size=4', 'num_workers=8', 'precision="fp32"', 'use_ema=True',
            f'out_path={dst!r}'], f'exps.inference {"--fold-bn " * fold}(fp32, EMA)')
        files = sorted(glob.glob(os.path.join(dst, 'outputs', '**', '*.json'), recursive=True))
        rows = []
        for file in files:
            objs = json.load(open(file))['CapturedObjects']
            arrs = [object_to_array(o) for o in objs]
            if not all(np.isfinite(a).all() and n in CLASSES for a, n in arrs):
                raise AssertionError(f'bad exported box in {file}')
            rows.append([(n, o['Score'], np.asarray(a[:3], np.float64))
                         for (a, n), o in zip(arrs, objs)])
        if len(files) != TREE_FRAMES['val']:
            raise AssertionError(f'exps.inference wrote {len(files)} files')
        exported[fold] = [os.path.relpath(f, dst) for f in files], rows
    (names, plain), (fnames, folded) = exported[False], exported[True]
    n, matched, worst = 0, 0, 0.0
    for a, b in zip(plain, folded):
        for name, score, xyz in a:
            n += 1
            dists = [float(np.abs(x[:2] - xyz[:2]).max()) for nm, sc, x in b
                     if nm == name and abs(sc - score) <= 2e-3]
            if dists and min(dists) <= 0.5:
                matched += 1
                worst = max(worst, min(dists))
    print(f'exps.inference on best: {len(names)} JSON files, {n} boxes; --fold-bn: {matched} '
          f'of them with the same label and a score within 2e-3, worst centre {worst:.4g} m',
          flush=True)
    if names != fnames or not n or matched < n:
        raise AssertionError(f'folded export: {matched} of {n} boxes matched')

    recorded = {}
    for d in os.listdir(best):
        with open(os.path.join(best, d, 'metrics.json')) as f:
            recorded[int(d)] = json.load(f)['val_detection_loss']
    best_step = min(recorded, key=lambda d: (recorded[d], -d))
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    ev = evaluate.main(['--config', 'lidar_cam_radar', '--data-root', root,
                        f'ckpt_path={best!r}', 'batch_size=4', 'num_workers=8',
                        f'out_path={os.path.join(out, "eval")!r}'] + flags)
    rel = abs(ev['test_detection_loss'] - recorded[best_step]) / abs(recorded[best_step])
    print(f'exps.evaluate on best (EMA, TTA): test_detection_loss '
          f'{ev["test_detection_loss"]:.6f} against the recorded {recorded[best_step]:.6f}, '
          f'relative {rel:.3e}', flush=True)
    if rel > 1e-4:
        raise AssertionError('exps.evaluate does not reproduce the recorded val loss on EMA')
    leaked = [m for m in ('cv2', 'PIL', 'jax', 'mm_training_tpu') if m in sys.modules]
    if leaked:
        raise AssertionError(f'the runtime phases imported {leaked}')
    with open(result_file, 'w') as f:
        json.dump({'counts': counts, 'wall_s': wall_s, 'panels': panels,
                   'profile_sessions': tries, 'profile_kernels': found,
                   'export_boxes': n, 'eval_rel': rel}, f)


def run_runtime(root):
    """:func:`runtime_child` in a child interpreter."""
    import tempfile
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        result_file = os.path.join(out, 'result.json')
        code = (f'import chip_smoke; chip_smoke.runtime_child({root!r}, {out!r}, '
                f'{result_file!r})')
        proc = subprocess.run([sys.executable, '-c', code], timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f'the runtime phases failed ({proc.returncode})')
        with open(result_file) as f:
            return json.load(f)


# --- phases 34-37: the checkpoint-import path (the sparse-import encoder)

SPARSE_TAILS = 21      # masked BN tails of the sparse-import encoder


def _sparse(cfg):
    from mm_training_tpu_torch.exps.kernel_inputs import sparse_import
    return sparse_import(cfg)


def _sparse_channels(cfg):
    """The channels K1's sparse mode writes for the sparse-import encoder."""
    from mm_training_tpu_torch.models.sparse_encoder import ImportSparseEncoder
    with torch.device('meta'):
        enc = ImportSparseEncoder(cfg.get_lidar_conf(), cfg.point_cloud_range, cfg.voxel_size,
                                  cfg.out_shape)
    return enc.input_channels


def _lidar_like_batch(cfg, batch_size, seed):
    """``make_fake_batch`` with LiDAR-like points (many pillars over the
    first-K cap) in place of its uniform cloud."""
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.exps.kernel_inputs import with_lidar_like_points
    return with_lidar_like_points(make_fake_batch(cfg, batch_size=batch_size, seed=seed), cfg,
                                  seed)


def _overfull(pts, mask, geo, cap):
    """(pillars holding more than ``cap`` points, points in them, the most
    points a pillar) of the first frame."""
    from mm_training_tpu_torch.ops import voxelize
    seg = voxelize.pillar_segments(pts[:1], mask[:1], *geo)[0]
    c = torch.bincount(seg, minlength=geo[2][0] * geo[2][1] + 1)[:-1]
    return int((c > cap).sum()), int(c[c > cap].sum()), int(c.max())


def check_sparse_kernels(cfg):
    """Phase 34: K1's sparse-input mode and masked A / A' at the sparse
    path's shapes against their plain versions, each timed beside its
    bound (bytes: each input read once, each output written once). K1 at
    B=1 and B=4 on LiDAR-like, uniform and crowded frames (20,000 points in
    one pillar of each frame), caps 1, the path's and 1000, bf16 and fp32,
    the same bits on a second call; then a frame of 2^24 points in one
    pillar (the selection's worst case) keeps exactly its first K."""
    from mm_training_tpu_torch.exps.kernel_inputs import lidar_like_points
    from mm_training_tpu_torch.exps.timing import device_ms, host_ms
    from mm_training_tpu_torch.ops import affine_act, voxelize

    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(SEED + 72)
    geo = (cfg.point_cloud_range, cfg.voxel_size, cfg.out_shape)
    nf = cfg.get_lidar_conf().voxelization.num_features
    cap = cfg.get_lidar_conf().voxelization.max_num_points
    channels = _sparse_channels(cfg)
    rows, occ4 = [], None
    for name, bsz in (('sparse_encoder_input', 1), ('sparse_encoder_input_b4', 4)):
        checks = {}
        for kind in ('lidar_like', 'uniform', 'crowded'):
            pts, mask = (_points(cfg, bsz, SEED + 70 + bsz) if kind == 'uniform'
                         else lidar_like_points(cfg, bsz, SEED + 70 + bsz,
                                                crowd=20_000 if kind == 'crowded' else 0))
            for dtype in (torch.bfloat16, torch.float32):
                for k in (cap, 1, 1000):
                    args = (pts, mask, *geo, nf, dtype, channels)
                    kw = dict(max_points_per_voxel=k)
                    grid, occ, kept = voxelize.sparse_encoder_input(*args, **kw,
                                                                    return_kept=True)
                    again = voxelize.sparse_encoder_input(*args, **kw, return_kept=True)
                    w_grid, w_occ, w_kept = voxelize.sparse_encoder_input_plain(
                        *args, **kw, return_kept=True)
                    w = w_grid.float()
                    ulp = (torch.where(w == 0, 0.0, torch.exp2(torch.floor(torch.log2(w.abs()))
                                                               - 7))
                           if dtype == torch.bfloat16 else torch.zeros_like(w))
                    diff = (grid.float() - w).abs()
                    key = f'{kind}, {str(dtype)[6:]}, cap {k}'
                    checks[key] = dict(
                        kept_equal=bool(torch.equal(kept, w_kept)),
                        occ_equal=bool(torch.equal(occ, w_occ)),
                        same_bits_twice=all(torch.equal(x, y)
                                            for x, y in zip((grid, occ, kept), again)),
                        outside_tolerance=int((diff > ulp + 1e-5 * (1 + w.abs())).sum()),
                        max_abs_err=diff.max().item(), kept=int(kept.sum()),
                        masked_in=int(mask.sum()), occupied=int(occ.sum()),
                        overfull=_overfull(pts, mask, geo, k))
                    if kind == 'lidar_like' and dtype == torch.bfloat16 and k == cap:
                        timed, path = (args, grid, occ, mask), checks[key]
                        if bsz == 4:
                            occ4 = occ
                    if kind == 'crowded' and dtype == torch.bfloat16 and k == cap:
                        crowded = args
        bad = {k: c for k, c in checks.items() if not (c['kept_equal'] and c['occ_equal']
                                                       and c['same_bits_twice']
                                                       and c['outside_tolerance'] == 0)}
        print(f'{name}: kernel vs plain {json.dumps(checks)}', flush=True)
        if bad:
            raise AssertionError(f'{name}: the kept set, the occupancy or the means differ, or '
                                 f'a second call differs {bad}')
        args, grid, occ, mask = timed
        kw = dict(max_points_per_voxel=cap)
        # the mask, the xyz of each masked-in point, the other features of
        # each kept one, the grid and the occupancy out
        nbytes = (mask.numel() + int(mask.sum()) * 3 * 4
                  + path['kept'] * (nf - 3) * 4 + grid.numel() * 2 + occ.numel())
        rows.append(dict(
            name=name, route='cuda', source='mm_training_tpu_torch/csrc/voxelize.cu',
            replaces='mm_training_tpu/ops/voxelize.py:81 (+ models/sparse_encoder.py:136-150)',
            max_abs_err=path['max_abs_err'],
            ms=device_ms(lambda: voxelize.sparse_encoder_input(*args, **kw), 100),
            call_ms=host_ms(lambda: voxelize.sparse_encoder_input(*args, **kw), 100),
            plain_ms=device_ms(lambda: voxelize.sparse_encoder_input_plain(*args, **kw), 10),
            crowded_ms=device_ms(lambda: voxelize.sparse_encoder_input(*crowded, **kw), 20),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by='bytes', library_ms=None,
            checks=checks, shape=list(args[0].shape), out_shape=list(grid.shape),
            dtype='bfloat16'))
        del pts, mask, grid, occ, kept, again, w_grid, w_occ, w_kept, timed, crowded

    # --- 2^24 points of one frame in one pillar: the kept set exactly the
    # first K indices, the mean theirs (features whose sums are exact in
    # fp32 in any order)
    n = 2 ** 24
    i = torch.arange(n, device=dev)
    big = torch.zeros(1, n, nf, device=dev)
    big[0, :, 3] = (i % 97).float()
    big[0, :, 4] = (i * 37 % 1024).float() / 1024
    big_mask = torch.ones(1, n, dtype=torch.bool, device=dev)
    big_geo = ((-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), (0.5, 0.5, 2.0), (4, 4))
    big_args = (big, big_mask, *big_geo, nf, torch.float32, channels)
    grid, occ, kept = voxelize.sparse_encoder_input(*big_args, max_points_per_voxel=cap,
                                                    return_kept=True)
    want = big[0, :cap].double().mean(0).float()
    one_pillar = dict(
        kept_first_k=bool(kept[0, :cap].all()) and not bool(kept[0, cap:].any()),
        occupied=int(occ.sum()), mean_err=(grid[0, 2, 2, :nf] - want).abs().max().item(),
        ms=device_ms(lambda: voxelize.sparse_encoder_input(*big_args,
                                                           max_points_per_voxel=cap), 3))
    print(f'sparse_encoder_input, 2^24 points in one pillar: {json.dumps(one_pillar)}',
          flush=True)
    if not (one_pillar['kept_first_k'] and one_pillar['occupied'] == 1
            and one_pillar['mean_err'] <= 1e-5 * float(want.abs().max())):
        raise AssertionError(f'sparse_encoder_input on 2^24 points in one pillar: {one_pillar}')
    rows[0]['one_pillar_2_24'] = one_pillar
    del big, big_mask, grid, occ, kept, i
    torch.cuda.empty_cache()

    # --- masked A and A' at the largest tail: [4, 16, 256, 2048] bf16 (the
    # conv_input and stage-0 tails), the B=4 frames' occupancy as the mask
    def cl(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x, g = cl(4, 16, 256, 2048), cl(4, 16, 256, 2048)
    r = (torch.relu(cl(4, 16, 256, 2048)) * occ4).contiguous(memory_format=torch.channels_last)
    s, t = torch.randn(16, generator=gen, device=dev), torch.randn(16, generator=gen, device=dev)
    fwd_equal = all(torch.equal(affine_act.affine_act_masked(x, s, t, occ4, res),
                                affine_act.affine_act_masked_plain(x, s, t, occ4, res))
                    for res in (None, r))
    bwd = {}
    for key, res in (('', None), ('_residual', r)):
        got = affine_act.affine_act_masked_backward(g, x, s, t, occ4, res)
        want = affine_act.affine_act_masked_backward_plain(g, x, s, t, occ4, res)
        again = affine_act.affine_act_masked_backward(g, x, s, t, occ4, res)
        bwd[key] = dict(dx_equal=bool(torch.equal(got[0], want[0])),
                        dr_equal=res is None or bool(torch.equal(got[1], want[1])),
                        sums_rel=max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                                     for a, b in zip(got[2:], want[2:])),
                        same_bits=all(torch.equal(a, b) for a, b in zip(got, again)
                                      if a is not None))
    print(f'masked A at [4, 16, 256, 2048] bf16 ({int(occ4.sum())} active pixels of '
          f'{occ4.numel()}): kernel equals plain {fwd_equal}; masked A\' {json.dumps(bwd)}',
          flush=True)
    if not fwd_equal or not all(b['dx_equal'] and b['dr_equal'] and b['same_bits']
                                and b['sums_rel'] <= 1e-4 for b in bwd.values()):
        raise AssertionError(f'masked A / A\' differ from their plain versions: {fwd_equal} {bwd}')
    el, npix = x.numel() * 2, occ4.numel()
    rows.append(dict(
        name='affine_act_masked', route='cuda', source='mm_training_tpu_torch/csrc/affine_act.cu',
        replaces='scripts/bn_elementwise_probe.py:88 (+ models/sparse_encoder.py:81-90, 101-111)',
        max_abs_err=0.0 if fwd_equal else None,
        ms=device_ms(lambda: affine_act.affine_act_masked(x, s, t, occ4), 100),
        call_ms=host_ms(lambda: affine_act.affine_act_masked(x, s, t, occ4), 100),
        residual_ms=device_ms(lambda: affine_act.affine_act_masked(x, s, t, occ4, r), 100),
        plain_ms=device_ms(lambda: affine_act.affine_act_masked_plain(x, s, t, occ4), 20),
        bound_ms=(2 * el + npix) / HBM_BYTES_PER_S * 1e3,
        residual_bound_ms=(3 * el + npix) / HBM_BYTES_PER_S * 1e3, bound_by='bytes',
        library_ms=None, shape=list(x.shape), dtype='bfloat16'))
    rows.append(dict(
        name='affine_act_masked_backward', route='cuda',
        source='mm_training_tpu_torch/csrc/affine_act_backward.cu',
        replaces='scripts/bn_elementwise_probe.py:88 (its autodiff)',
        max_abs_err=bwd[''], checks=bwd,
        ms=device_ms(lambda: affine_act.affine_act_masked_backward(g, x, s, t, occ4), 50),
        call_ms=host_ms(lambda: affine_act.affine_act_masked_backward(g, x, s, t, occ4), 50),
        residual_ms=device_ms(lambda: affine_act.affine_act_masked_backward(g, x, s, t, occ4, r),
                              50),
        plain_ms=device_ms(lambda: affine_act.affine_act_masked_backward_plain(g, x, s, t, occ4),
                           10),
        bound_ms=(3 * el + npix) / HBM_BYTES_PER_S * 1e3,
        residual_bound_ms=(5 * el + npix) / HBM_BYTES_PER_S * 1e3, bound_by='bytes',
        library_ms=None, shape=list(x.shape), dtype='bfloat16'))
    rows[-1]['max_abs_err'] = 0.0 if bwd['']['dx_equal'] else None
    for row in rows[:2]:
        print(f'{row["name"]}: {row["ms"]:.5f} ms (host call {row["call_ms"]:.5f}), bound '
              f'{row["bound_ms"]:.5f}, plain {row["plain_ms"]:.5f}; 20,000 points of each '
              f'frame in one pillar {row["crowded_ms"]:.5f}', flush=True)
    for row in rows[-2:]:
        print(f'{row["name"]}: {row["ms"]:.5f} ms (host call {row["call_ms"]:.5f}), bound '
              f'{row["bound_ms"]:.5f}, plain {row["plain_ms"]:.5f}; with a residual '
              f'{row["residual_ms"]:.5f} (bound {row["residual_bound_ms"]:.5f})', flush=True)
    del x, g, r
    torch.cuda.empty_cache()
    return rows


def serve_sparse(cfg, samples=(60, 20)):
    """Phase 35: the ``sparse_import`` ``lidar_radar`` predict path at B=1
    and B=4 on LiDAR-like requests, beside the dense encoder's (p50 in
    alternating rounds, one process)."""
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.training import make_predict_step

    scfg = _sparse(cfg)
    gen = torch.Generator().manual_seed(SEED + 73)
    model = BEVDepthLiDAR(scfg, device='cuda', generator=gen)
    _randomize_bn(model, gen)
    dense = BEVDepthLiDAR(cfg, device='cuda', generator=gen)
    _randomize_bn(dense, gen)
    predict, dense_predict = make_predict_step(scfg, model), make_predict_step(cfg, dense)
    requests = [_lidar_like_batch(scfg, 1, SEED + 74 + i) for i in range(3)]
    big = _lidar_like_batch(scfg, 4, SEED + 77)
    for req in requests + [big]:
        [o.cpu() for o in predict(req)]                     # warm
    out, per, plain_calls, _ = _counted(lambda: [[o.cpu() for o in predict(r)]
                                                 for r in requests])
    n_req = len(requests)
    dense_out, dense_per, _, _ = _counted(lambda: [o.cpu() for o in dense_predict(requests[0])])
    head_tails = dense_per['affine_act'] - len(_encoder_tails(dense))
    want = {'sparse_encoder_input': n_req, 'affine_act_masked': SPARSE_TAILS * n_req,
            'affine_act': head_tails * n_req, 'circle_nms_mask': n_req,
            'pillar_encoder_input': 0, 'voxelize_pillars_dense': 0}
    wrong = {k: per[k] for k, v in want.items() if per[k] != v}
    if plain_calls or wrong:
        raise AssertionError(f'sparse serve launches {per}: expected {want}; plain versions '
                             f'called {plain_calls}')
    for boxes, scores, _, valid in out:
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all() and valid.any()):
            raise AssertionError('sparse serve: non-finite boxes or scores, or none')
    p50 = {}
    for b, reqs, n in ((1, requests[0], samples[0]), (4, big, samples[1])):
        p50[b] = _alternating_p50({'sparse': lambda r=reqs: predict(r),
                                   'dense': lambda r=reqs: dense_predict(r)}, n)
    peak = {k: _request_peak_gib(lambda fn=fn: fn(big)) for k, fn in
            (('sparse', predict), ('dense', dense_predict))}
    ops = _path_device_ops('lidar_radar sparse_import B=1 request',
                           lambda: [o.cpu() for o in predict(requests[0])])
    maps_vs_plain = compare_plain(model, requests[0])
    print(f'serve sparse_import lidar_radar: launches a B=1 request '
          f'{json.dumps({k: v // n_req for k, v in per.items() if v})} (dense head tails '
          f'{head_tails}); p50/p90 ms B=1 sparse {p50[1]["sparse"][0]:.3f}/{p50[1]["sparse"][1]:.3f}'
          f', dense {p50[1]["dense"][0]:.3f}/{p50[1]["dense"][1]:.3f} ({p50[1]["sparse"][2]} '
          f'samples each); B=4 sparse {p50[4]["sparse"][0]:.3f}/{p50[4]["sparse"][1]:.3f}, dense '
          f'{p50[4]["dense"][0]:.3f}/{p50[4]["dense"][1]:.3f} ({p50[4]["sparse"][2]} each); peak '
          f'GiB of a B=4 request above the held: sparse {peak["sparse"][0]:.4f}, dense '
          f'{peak["dense"][0]:.4f}', flush=True)
    del model, dense, predict, dense_predict
    torch.cuda.empty_cache()
    compare_cpu_reference(_sparse(_tiny()))
    return {'counts': per, 'requests': n_req, 'p50': p50, 'peak': peak, 'device_ops': ops,
            'maps_vs_plain': maps_vs_plain, 'head_tails': head_tails}


def _tiny():
    from mm_training_tpu_torch.configs import tiny_test_config
    return tiny_test_config(use_cam=False)


def _encoder_tails(model):
    """The BN tails (kernel A launches) of a model's LiDAR encoder."""
    from mm_training_tpu_torch.models.bn_fold import BatchNorm2d
    return [m for m in model.lidar_encoder.modules() if isinstance(m, BatchNorm2d)]


def train_sparse(cfg, steps=5):
    """Phase 36: the ``sparse_import`` ``lidar_radar`` train path at B=4
    (bf16 compute over float32 masters) on a LiDAR-like batch."""
    from mm_training_tpu_torch.exps.profile_train import benchmark_train
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.models.bn_fold import MaskedBatchNorm2d
    from mm_training_tpu_torch.training import (create_train_state, loss_and_grads,
                                                make_eval_step, make_train_step)

    scfg = _sparse(cfg).replace(batch_size=4)
    model = BEVDepthLiDAR(scfg, device='cuda', generator=torch.Generator().manual_seed(SEED + 78))
    state = create_train_state(scfg, model)
    train_step, eval_step = make_train_step(scfg), make_eval_step(scfg)
    batch = _lidar_like_batch(scfg, 4, SEED + 79)

    def run():
        box = [state]
        for _ in range(2):
            box[0], _ = train_step(box[0], batch)
        stats = benchmark_train(train_step, box[0], batch, steps=steps)
        ev = eval_step(box[0], batch)
        return stats, ev
    (stats, (ev_metrics, (boxes, scores, _, _), _)), counts, plain_calls, wall_s = _counted(run)
    n = steps + 2
    want = {'sparse_encoder_input': n + 1, 'affine_act_masked': SPARSE_TAILS * (n + 1),
            'affine_act_masked_backward': SPARSE_TAILS * n, 'draw_heatmap': n + 1,
            'circle_nms_mask': 1, 'pillar_encoder_input': 0}
    wrong = {k: counts[k] for k, v in want.items() if counts[k] != v}
    if plain_calls or wrong or counts['affine_act_backward'] == 0:
        raise AssertionError(f'sparse train launches {counts}: expected {want}; plain versions '
                             f'called {plain_calls}')
    if not (all(np.isfinite(stats['losses'])) and torch.isfinite(ev_metrics['loss'])
            and torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError('sparse train: non-finite loss or eval boxes')
    print(f'train sparse_import lidar_radar B=4: step p50 {stats["p50_ms"]:.3f} ms p90 '
          f'{stats["p90_ms"]:.3f} ms, {stats["samples_per_s"]:.3f} samples/s, '
          f'max_memory_allocated {stats["max_memory_allocated_gb"]:.3f} GiB; losses '
          f'{[round(v, 4) for v in stats["losses"]]}; eval loss {float(ev_metrics["loss"]):.4f};'
          f' launches over {n} steps and 1 eval '
          f'{json.dumps({k: v for k, v in counts.items() if v})}', flush=True)

    # every masked BN's batch statistics on this step's own inputs: the
    # card's float32 against float64 on the CPU
    inputs = []
    hooks = [m.register_forward_pre_hook(lambda m, a: inputs.append((m, a[0].detach(), a[1])))
             for m in state.model.modules() if isinstance(m, MaskedBatchNorm2d)]
    buffers = {k: b.clone() for k, b in state.model.named_buffers()}
    try:
        loss_and_grads(scfg, state, batch)
    finally:
        for h in hooks:
            h.remove()
        state.model.load_state_dict(buffers, strict=False)
    worst = 0.0
    for m, x, mask in inputs:
        got = m.batch_statistics(x, torch.float32, mask)
        want64 = m.batch_statistics(x.cpu().double(), torch.float64, mask.cpu())
        for a, b in zip(got, want64):
            worst = max(worst, ((a.cpu().double() - b).abs() / (1 + b.abs())).max().item())
    print(f'masked BN statistics of {len(inputs)} BNs, card float32 vs float64: worst '
          f'{worst:.3g} (of 1 + |value|)', flush=True)
    if len(inputs) != SPARSE_TAILS or not worst <= 1e-5:
        raise AssertionError(f'masked BN statistics differ from float64 by {worst}')
    grads_rel = compare_plain_gradients_sparse(scfg, state, batch)
    del state, model
    torch.cuda.empty_cache()
    compare_cpu_train(_sparse(_tiny()))
    return {'counts': counts, 'steps': n, 'stats': stats, 'bn_stats_worst': worst,
            'grads_vs_plain': grads_rel}


def compare_plain_gradients_sparse(cfg, state, batch):
    """Phase 36b: one ``sparse_import`` step's gradients through the kernels
    against the same step with every kernel swapped for its plain version,
    each beside the plain path's own run-to-run difference (two plain runs),
    in bf16 and in float32 compute (TF32 off); held within 1/32 (L2) in
    float32, as phase 12 holds the camera step: in bf16 the plain path is no
    yardstick here. K1's float sums (the kernel's atomics, the plain
    version's CUDA ``index_add_``) add in no fixed order, a flipped bf16
    rounding of the grid at full resolution reaches 21 train-mode masked
    BNs, and their backward amplifies it."""
    from mm_training_tpu_torch.training import loss_and_grads

    names = [n for n, _ in state.model.named_parameters()]
    buffers = {n: b.clone() for n, b in state.model.named_buffers()}

    def l2(ts):
        return torch.sqrt(sum((t.double() ** 2).sum() for t in ts))
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        for label, c in (('bf16', cfg), ('fp32', cfg.replace(precision='fp32'))):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            loss, got, _ = loss_and_grads(c, state, batch)
            state.model.load_state_dict(buffers, strict=False)
            before = {n: w.launches for n, w in _wrappers().items()}
            plain = []
            with _plain_versions():
                for _ in range(2):
                    plain.append(loss_and_grads(c, state, batch))
                    state.model.load_state_dict(buffers, strict=False)
            if {n: w.launches for n, w in _wrappers().items()} != before:
                raise AssertionError('the plain run launched a kernel')
            loss_p, want, _ = plain[0]
            per = sorted(((((a - b).norm() / b.norm().clamp_min(1e-30)).item(), n)
                          for a, b, n in zip(got, want, names)), reverse=True)
            out[label] = {
                'grad_rel_l2': (l2([a - b for a, b in zip(got, want)]) / l2(want)).item(),
                'plain_run_to_run_rel_l2': (l2([a - b for a, b in zip(plain[1][1], want)])
                                            / l2(want)).item(),
                'loss_rel': abs(loss.item() - loss_p.item()) / abs(loss_p.item()),
                'worst_tensors': [(n, round(v, 5)) for v, n in per[:4]]}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    print('sparse_import train gradients kernels vs plain (B=4): ' + json.dumps(out), flush=True)
    if not (out['fp32']['grad_rel_l2'] <= 1 / 32 and out['fp32']['loss_rel'] <= 1 / 32):
        raise AssertionError(f'kernel and plain sparse gradients differ: {out}')
    return out


def import_child(root, out, result_file):
    """Phase 37 in a process of its own (see the module docstring)."""
    import glob
    from mm_training_tpu_torch.configs import lidar_cam_radar
    from mm_training_tpu_torch.exps import parity
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.models.bn_fold import MaskedBatchNorm2d, fold_model
    from mm_training_tpu_torch.models.torch_export import (export_reference_checkpoint,
                                                           save_torch_checkpoint)
    from mm_training_tpu_torch.scripts import import_checkpoint
    from mm_training_tpu_torch.training import make_predict_step

    cfg = _sparse(lidar_cam_radar(batch_size=1, max_points_per_frame=100_000))
    gen = torch.Generator().manual_seed(SEED + 90)
    src = BEVDepthLiDAR(cfg, device='cuda', generator=gen)
    _randomize_bn(src, gen)
    _randomize_offsets(src, gen)
    ckpt_dir = os.path.join(out, 'ckpts')
    os.makedirs(ckpt_dir)
    ckpt = os.path.join(ckpt_dir, 'lidar_cam_radar.ckpt')
    t0 = time.perf_counter()
    save_torch_checkpoint(ckpt, export_reference_checkpoint(src.state_dict(), cfg))
    export_s = time.perf_counter() - t0
    converted = os.path.join(out, 'converted')
    report, counts, import_s = _counted_entry(import_checkpoint.main, [
        ckpt, '--config', 'lidar_cam_radar', '--out', converted,
        'max_points_per_frame=100000'], 'scripts.import_checkpoint')
    if not (report['unrecognized_keys'] == [] and report['skipped_lidar_encoder_keys'] == 0
            and report['forward_smoke'] == 'ok' and report['skipped_dead_context_se_keys'] == 4):
        raise AssertionError(f'import report {report}')
    if counts['sparse_encoder_input'] != 1 or counts['affine_act_masked'] != SPARSE_TAILS:
        raise AssertionError(f'the import smoke predict launched {counts}')
    tree = torch.load(os.path.join(converted, '0', 'state.pt'), map_location='cpu',
                      weights_only=True)
    own = src.state_dict()
    unequal = [k for k in own if not torch.equal(tree['model'][k], own[k].cpu())]
    if set(tree['model']) != set(own) or unequal:
        raise AssertionError(f'the imported state differs from the source: {unequal[:8]}')
    imported = BEVDepthLiDAR(cfg, device='cuda', generator=torch.Generator().manual_seed(1))
    imported.load_state_dict(tree['model'])
    request = _lidar_like_batch(cfg, 1, SEED + 91)
    fp32 = cfg.replace(precision='fp32')
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    ref = [o.cpu() for o in make_predict_step(fp32, src)(request)]
    (got, got_counts, plain_calls, _) = _counted(
        lambda: [o.cpu() for o in make_predict_step(fp32, imported)(request)])
    share, worst, n_boxes = _box_match(ref, got, 1e-4)
    folded = copy.deepcopy(imported)
    pairs = fold_model(folded)
    masked = sum(isinstance(m, MaskedBatchNorm2d) for m in folded.modules())
    fold_out, fold_counts, fold_plain, _ = _counted(
        lambda: [o.cpu() for o in make_predict_step(fp32, folded)(request)])
    fold_share, fold_worst, _ = _box_match(ref, fold_out, 2e-3)
    torch.backends.cudnn.allow_tf32 = True
    print(f'import loop: exported in {export_s:.3f} s, imported in {import_s:.3f} s '
          f'({report["converted_leaves"]} tensors, {report["source_keys"]} source keys); the '
          f'state equal bit for bit; fp32 boxes imported vs source {share:.4f} of {n_boxes} '
          f'(worst centre {worst:.3g} m); folded ({len(pairs)} pairs, {masked} masked BNs '
          f'unfolded, masked A {fold_counts["affine_act_masked"]} a request) {fold_share:.4f} '
          f'within 2e-3 (worst {fold_worst:.3g} m)', flush=True)
    if not (share == 1.0 and worst <= 1e-3 and fold_share == 1.0 and masked == SPARSE_TAILS
            and not plain_calls and not fold_plain
            and fold_counts['affine_act_masked'] == SPARSE_TAILS
            and not any(bn.startswith('lidar_encoder.') for _, bn, _, _ in pairs)):
        raise AssertionError('the imported or folded model does not give the source\'s boxes')
    del src, imported, folded
    torch.cuda.empty_cache()
    parity_out = os.path.join(out, 'parity')
    t0 = time.perf_counter()
    rep, parity_counts, _ = _counted_entry(parity.main, [
        '--data-root', root, '--ckpt-dir', ckpt_dir, '--out', parity_out,
        '--variants', 'lidar_cam_radar', '--odds', 'highway', '--max-batches', '2'],
        'exps.parity')
    parity_s = time.perf_counter() - t0
    res = rep['results']['lidar_cam_radar']
    reports = sorted(os.path.basename(f) for f in glob.glob(os.path.join(parity_out, '*')))
    if ('error' in res or 'parity_report.md' not in reports or 'parity_report.json' not in reports
            or not np.isfinite(res['per_odd']['highway']['test_highway_detection_loss'])):
        raise AssertionError(f'exps.parity: {res}, {reports}')
    print(f'exps.parity (lidar_cam_radar, highway, 2 batches): {parity_s:.3f} s, '
          f'{json.dumps(res["per_odd"]["highway"])[:300]}', flush=True)
    leaked = [m for m in ('cv2', 'PIL', 'jax', 'mm_training_tpu') if m in sys.modules]
    if leaked:
        raise AssertionError(f'the import phases imported {leaked}')
    for key, c in (('fold', fold_counts), ('parity', parity_counts)):
        for k, v in c.items():
            counts[k] += v
    for k, v in got_counts.items():
        counts[k] += v
    with open(result_file, 'w') as f:
        json.dump({'counts': counts, 'export_s': export_s, 'import_s': import_s,
                   'parity_s': parity_s, 'box_share': share, 'fold_share': fold_share,
                   'boxes': n_boxes}, f)


def run_import(root):
    """:func:`import_child` in a child interpreter."""
    import tempfile
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        result_file = os.path.join(out, 'result.json')
        code = (f'import chip_smoke; chip_smoke.import_child({root!r}, {out!r}, '
                f'{result_file!r})')
        proc = subprocess.run([sys.executable, '-c', code], timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f'the import phases failed ({proc.returncode})')
        with open(result_file) as f:
            return json.load(f)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from mm_training_tpu_torch.configs import (lidar_cam_radar, lidar_radar, raw_rig,
                                               tiny_test_config)
    from mm_training_tpu_torch.data import random_bda_matrices
    from mm_training_tpu_torch.exps.profile_train import RAW_RIG_PITCH_DEG
    from mm_training_tpu_torch.ops import build

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f'torch {torch.__version__} cuda {torch.version.cuda} on {card}', flush=True)
    t0 = time.perf_counter()
    build.build_kernels()
    print(f'build: {time.perf_counter() - t0:.3f} s for {len(build.KERNEL_SOURCES)} '
          'kernels (parallel nvcc)', flush=True)

    cfg = lidar_radar(batch_size=1, max_points_per_frame=100_000)
    cam_cfg = lidar_cam_radar(batch_size=1, max_points_per_frame=100_000)
    ops_per_call = count_device_ops(cfg, cam_cfg)
    rows = check_kernels(cfg)
    model, request, counts, calls = serve(cfg)
    compare_plain(model, request)
    compare_cpu_reference()
    del model
    cfg4, state, batch, train_counts, _ = train(cfg)
    compare_plain_gradients(cfg4, state, batch)
    del state
    compare_cpu_train()

    rows += check_sparse_kernels(cfg)
    sparse_serve = serve_sparse(cfg)
    sparse_train = train_sparse(cfg)

    rows += check_camera_kernels(cam_cfg)
    cam_model, cam_request, cam_counts, cam_calls, _ = serve_camera(cam_cfg)
    compare_plain_camera(cam_model, cam_cfg, cam_request)
    del cam_model
    for kw in (dict(), dict(use_depth_loss=False)):
        compare_cpu_reference(tiny_test_config(use_cam=True, **kw),
                              bda=random_bda_matrices(2, SEED + 13))

    rows += check_backward_kernels(cam_cfg)
    cam_train_counts, _ = train_camera(cam_cfg)
    compare_plain_gradients_camera(cam_cfg)
    compare_cpu_train(tiny_test_config(use_cam=True))

    rows += check_raw_splat_kernels(cam_cfg)
    raw_cfg = raw_rig(cam_cfg)
    raw_model, raw_request, raw_counts, raw_calls, _ = serve_camera(raw_cfg, RAW_RIG_PITCH_DEG,
                                                                    iters=(30, 10))
    compare_plain_camera(raw_model, raw_cfg, raw_request)
    del raw_model
    for kw in (dict(), dict(use_depth_loss=False)):
        compare_cpu_reference(raw_rig(tiny_test_config(use_cam=True, **kw)),
                              bda=random_bda_matrices(2, SEED + 13), pitch_deg=RAW_RIG_PITCH_DEG)
    raw_train_counts, _ = train_camera(raw_cfg, RAW_RIG_PITCH_DEG, steps=5)
    compare_plain_gradients_camera(raw_cfg, RAW_RIG_PITCH_DEG)
    compare_cpu_train(raw_rig(tiny_test_config(use_cam=True)), RAW_RIG_PITCH_DEG)

    serving = {'lidar_radar': serve_tta_and_folded(cfg, 60),
               'lidar_cam_radar': serve_tta_and_folded(cam_cfg, 30)}
    for kw in (dict(use_cam=False), dict(use_cam=True)):
        compare_cpu_reference(tiny_test_config(**kw), fold=True)
    ema_train = train_ema(cam_cfg)

    import shutil
    import tempfile
    tree = tempfile.mkdtemp(prefix='aim_tree_')
    fisheye_tree = tempfile.mkdtemp(prefix='aim_fisheye_tree_')
    try:
        tree_stats = write_tree(tree, fisheye_tree)
        shutil.rmtree(fisheye_tree, ignore_errors=True)
        trainer = run_trainer(tree)
        cam_trainer = run_trainer(tree, 'lidar_cam_radar')
        runtime = run_runtime(tree)
        imported = run_import(tree)
    finally:
        shutil.rmtree(tree, ignore_errors=True)
        shutil.rmtree(fisheye_tree, ignore_errors=True)
    print(f'trainer phases on {card}: ' + json.dumps(dict(tree_stats, **{
        k: v for k, v in trainer.items() if k != 'counts'})), flush=True)
    print(f'camera trainer phases on {card}: ' + json.dumps({
        k: v for k, v in cam_trainer.items() if not k.endswith('counts')}), flush=True)
    print(f'serving runtime phases (TTA, folded) on {card}: ' + json.dumps({
        name: {kind: {k: v for k, v in r.items() if not k.startswith('launches')}
               for kind, r in res.items()} for name, res in serving.items()}), flush=True)
    print(f'EMA training phase on {card}: ' + json.dumps(
        {k: v for k, v in ema_train.items() if k != 'counts'}), flush=True)
    print(f'runtime phases (EMA, TTA, viz, profile, inference) on {card}: ' + json.dumps(
        {k: v for k, v in runtime.items() if k != 'counts'}), flush=True)
    print(f'checkpoint-import phases (sparse_import serve, train, import loop) on {card}: '
          + json.dumps({'serve': {k: v for k, v in sparse_serve.items() if k != 'counts'},
                        'train': {k: v for k, v in sparse_train.items() if k != 'counts'},
                        'import': {k: v for k, v in imported.items() if k != 'counts'}}),
          flush=True)
    leaked = [m for m in ('cv2', 'PIL', 'jax', 'mm_training_tpu') if m in sys.modules]
    if leaked:
        raise AssertionError(f'chip_smoke imported {leaked}')

    wrappers = _wrappers()
    for row in rows:
        name = max((w for w in wrappers if row['name'].startswith(w)), key=len)
        by_path = {'serve': counts[name], 'train': train_counts[name],
                   'serve_camera': cam_counts[name], 'train_camera': cam_train_counts[name],
                   'serve_camera_raw': raw_counts[name],
                   'train_camera_raw': raw_train_counts[name],
                   'trainer': trainer['counts'][name],
                   'trainer_camera': cam_trainer['counts'][name],
                   'trainer_camera_depth_gt': cam_trainer['depth_gt_counts'][name],
                   'serve_tta': sum(r['tta']['launches_tta'][name] for r in serving.values()),
                   'serve_folded': sum(r['folded']['launches'][name]
                                       for r in serving.values()),
                   'train_ema': ema_train['counts'][name],
                   'trainer_runtime': runtime['counts'][name],
                   'serve_sparse': sparse_serve['counts'][name],
                   'train_sparse': sparse_train['counts'][name],
                   'import_loop': imported['counts'][name]}
        row['launches'] = sum(by_path.values())
        row['launches_by_path'] = by_path
        row['launches_per_request'] = {'serve': counts[name] / calls,
                                       'serve_camera': cam_counts[name] / cam_calls,
                                       'train_camera_step': cam_train_counts[name] / 13,
                                       'serve_camera_raw': raw_counts[name] / raw_calls,
                                       'train_camera_raw_step': raw_train_counts[name] / 8,
                                       'serve_tta_lidar_radar':
                                           serving['lidar_radar']['tta']['launches_tta'][name],
                                       'serve_tta_lidar_cam_radar':
                                           serving['lidar_cam_radar']['tta']['launches_tta'][name],
                                       'serve_sparse': sparse_serve['counts'][name]
                                       / sparse_serve['requests'],
                                       'train_sparse_step': sparse_train['counts'][name]
                                       / sparse_train['steps']}
        if row['name'] in ops_per_call:
            row['device_kernels_per_call'] = ops_per_call[row['name']]
    print(json.dumps({'kernels': rows}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
