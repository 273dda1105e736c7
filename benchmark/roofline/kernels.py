"""Each port kernel's least time in a step, from the operations and bytes
that the step's inputs need at the configuration's shapes: the larger of
the bytes over the HBM rate and the operations over the bf16 peak. Each
tensor is counted read or written once, at the width of the precision the
configuration states (2 bytes in bf16; the index and point inputs at their
own), and only what the work needs: a kernel's padding, scratch and index
tables are not counted. A kernel is found in a device trace by a substring
of its name (the frozen ``KERNEL_NAMES`` of ``exps/profile_train.py``)."""
from __future__ import annotations

from typing import Dict

from .peaks import BF16_FLOPS, HBM_BYTES_PER_S

# kernel -> substring of its device name
KERNEL_NAMES = {
    'A': 'affine_act_kernel', "A'": 'affine_act_bwd', 'K1': 'pillar_kernel',
    'K2': 'heatmap_kernel', 'K3': 'circle_nms', 'K4': 'lift_splat_kernel',
    "K4'": 'lift_splat_bwd', 'K5': 'deform_conv_kernel', "K5'": 'deform_bwd',
    'K6': 'depth_labels_kernel', 'K7': 'bev_warp_kernel', "K7'": 'bev_warp_bwd'}


def kernel_of(device_name: str):
    """The kernel a device operation belongs to, or None."""
    for k, sub in KERNEL_NAMES.items():
        if sub in device_name:
            return k
    return None


def _t(*tensors: float, flops: float = 0.0) -> float:
    """Least seconds for tensors of these sizes (bytes) and ``flops``."""
    return max(sum(tensors) / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def step_bounds(cfg, batch: int, norms, deform_flops: float, train: bool,
                precision: str) -> Dict[str, float]:
    """{kernel: least seconds in one step} at the widths of ``precision``
    (the configuration's). ``norms``: (elements, with a residual) of each
    BatchNorm call of the forward; ``deform_flops``: the deformable conv's
    forward products."""
    e = 2 if precision == 'bf16' else 4
    out: Dict[str, float] = {}
    out['A'] = sum(_t(*[n * e] * (3 if r else 2)) for n, r in norms)
    if train:
        out["A'"] = sum(_t(*[n * e] * (4 if r else 3)) for n, r in norms)
    head = cfg.get_head_conf()
    ny, nx = cfg.out_shape
    if cfg.use_lidar:
        f = cfg.lidar_input_channels
        out['K1'] = _t(batch * cfg.max_points * 4 * f, batch * cfg.max_points,
                       batch * ny * nx * f * e)
    osf = head.train_cfg.out_size_factor
    classes = sum(t.num_class for t in head.tasks)
    if train:
        out['K2'] = _t(batch * classes * (ny // osf) * (nx // osf) * 4)
    else:
        k = head.bbox_coder.max_num
        out['K3'] = _t(batch * len(head.tasks) * k * (3 * 4 + 1))
    if cfg.use_cam:
        bb = cfg.get_backbone_conf()
        fh, fw = bb.feat_hw
        m = batch * cfg.num_sweeps * cfg.num_cameras
        d, c = bb.depth_channels, bb.output_channels
        hb, wb = bb.bev_hw
        depth, ctx, bev = m * d * fh * fw * e, m * fh * fw * c * e, m * hb * wb * c * e
        out['K4'] = _t(depth, ctx, bev)
        mid = bb.depth_net_conf.mid_channels
        x = batch * cfg.num_cameras * fh * fw * mid * e
        offsets = batch * cfg.num_cameras * fh * fw * 18 * 4
        out['K5'] = _t(x, offsets, x, flops=deform_flops)
        if cfg.use_depth_loss:
            out['K6'] = _t(batch * cfg.max_points * 3 * 4, batch * cfg.num_cameras * fh * fw * d * 4)
        warp = batch * cfg.num_sweeps * hb * wb * c * e
        out['K7'] = _t(warp, warp)
        if train:
            out["K4'"] = _t(bev, depth, ctx, depth, ctx)
            out["K5'"] = _t(x, x, offsets, x, offsets, flops=2 * deform_flops)
            out["K7'"] = _t(warp, warp)
    return out
