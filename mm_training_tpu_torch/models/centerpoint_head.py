"""CenterPoint-style BEV detection head, targets, losses and box decode.

The port of ``mm_training_tpu/models/centerpoint_head.py``:
``SeparateHead`` and ``BEVDepthHead`` (ResNet-18 trunk -> SECONDFPN ->
shared conv -> per-task branches); ``get_targets`` (heatmaps through kernel
K2, the per-task ``[max_objs, 10]`` box targets by a cumsum slot scatter),
batched over samples where the JAX function is vmapped;
``gaussian_focal_loss`` and ``detection_loss``; and ``decode_boxes`` (top-k,
box decode, post-centre range, circle NMS through kernel K3, top
``post_max_size`` survivors). Names follow mmdet3d (``trunk``, ``neck``,
``shared_conv``, ``task_heads.{t}.{head}.{i}``). The head has no layer that
changes in train mode other than its BatchNorms (``model.train()``).

On a model axis (``parallel/spatial.py``) the head runs on a W shard of the
fused BEV and returns the shard of every map; ``targets_on_columns`` cuts
the targets to it, so that ``detection_loss`` covers the shard's cells and
objects and its normalizers, summed over the world, count each once.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import parallel
from ..configs import HeadConf
from ..ops import circle_nms, gaussian
from ..parallel import spatial
from .resnet import ConvBN, ResNet
from .second_fpn import SECONDFPN

__all__ = ['SeparateHead', 'BEVDepthHead', 'decode_boxes', 'clip_sigmoid',
           'heatmap_inputs', 'get_targets', 'targets_on_columns', 'gaussian_focal_loss',
           'detection_loss']


class SeparateHead(nn.Module):
    """Per-task branches (mmdet3d SeparateHead): ``num_conv - 1`` ConvModules
    (conv, BN, ReLU) and a final conv with bias; the heatmap's final bias
    starts at ``init_bias``. The flax branch convs carry a bias that the
    weight carry folds into the following BN's running mean."""

    def __init__(self, in_channels: int,
                 heads: Sequence[Tuple[str, Tuple[int, int]]],
                 head_conv: int = 64, final_kernel: int = 3,
                 init_bias: float = -2.19):
        super().__init__()
        self.head_names = tuple(name for name, _ in heads)
        self.init_bias = init_bias
        for name, (out_ch, num_conv) in heads:
            layers, c = [], in_channels
            for _ in range(num_conv - 1):
                layers.append(ConvBN(c, head_conv, final_kernel))
                c = head_conv
            layers.append(nn.Conv2d(c, out_ch, final_kernel,
                                    padding=final_kernel // 2, bias=True))
            self.add_module(name, nn.Sequential(*layers))

    def forward(self, x: torch.Tensor, axis=None, padded: bool = False
                ) -> Dict[str, torch.Tensor]:
        """Each branch on ``x``; on a model axis ``x`` is a W shard, which
        with ``padded`` holds the halo of the branches' first convs already
        (every branch's first conv has the same kernel)."""
        if axis is None:
            return {name: getattr(self, name)(x) for name in self.head_names}
        out = {}
        for name in self.head_names:
            y = x
            for i, layer in enumerate(getattr(self, name)):
                conv = layer.conv if isinstance(layer, ConvBN) else layer
                y = spatial.conv2d(conv, y, axis, padded=padded and i == 0)
                if isinstance(layer, ConvBN):
                    y = layer.bn(y)
            out[name] = y
        return out


class BEVDepthHead(nn.Module):
    """BEV trunk + neck + CenterPoint task heads.

    Input [B, C, H/8, W/8] (channels_last); output a list over tasks of
    dicts of NHWC [B, H/4, W/4, ch] maps, the JAX package's layout (views of
    the channels_last results, no copy). On a model ``axis`` the input and
    the maps are this rank's W shards."""

    def __init__(self, conf: HeadConf):
        super().__init__()
        self.conf = conf
        bb, nk = conf.bev_backbone_conf, conf.bev_neck_conf
        self.trunk = ResNet(depth=18, in_channels=bb.in_channels,
                            base_channels=bb.base_channels,
                            num_stages=bb.num_stages, strides=bb.strides,
                            out_indices=bb.out_indices)
        self.neck = SECONDFPN(nk.in_channels, nk.out_channels, nk.upsample_strides)
        # the reference's shared conv carries a bias (zero from a flax init)
        self.shared_conv = ConvBN(sum(nk.out_channels), 64, 3, conv_bias=True)
        self.task_heads = nn.ModuleList(
            SeparateHead(64, tuple(conf.common_heads) + (('heatmap', (t.num_class, 2)),),
                         final_kernel=conf.final_kernel, init_bias=conf.init_bias)
            for t in conf.tasks)

    @property
    def total_stride(self) -> int:
        """The stride of the trunk's last stage: a W shard of the input is
        a multiple of it."""
        return self.trunk.total_stride

    def forward(self, x: torch.Tensor, axis=None) -> List[Dict[str, torch.Tensor]]:
        # the SECONDFPN's convs and transposed convs have kernel = stride:
        # no halo
        shared = self.shared_conv(self.neck(self.trunk(x, axis)), axis)
        padded = axis is not None
        if padded:       # one halo for the first conv of every branch
            k = self.conf.final_kernel
            shared = spatial.halo_pad(shared, *spatial.halo(k, 1, k // 2), axis)
        return [{k: v.permute(0, 2, 3, 1) for k, v in head(shared, axis, padded).items()}
                for head in self.task_heads]


def _task_class_offsets(conf: HeadConf) -> List[int]:
    offs, flag = [], 0
    for t in conf.tasks:
        offs.append(flag)
        flag += t.num_class
    return offs


# ------------------------------------------------------------------ targets

def clip_sigmoid(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """mmdet3d clip_sigmoid."""
    return torch.clamp(torch.sigmoid(x), eps, 1.0 - eps)


def _object_geometry(conf: HeadConf, gt_boxes: torch.Tensor):
    """Feature-map geometry of every padded object [B, K]: the float
    coordinates, their int32 cells (truncated toward zero, as
    ``astype(int32)``), the int32 radii, and whether the box has a size and
    its cell lies on the map."""
    tc = conf.train_cfg
    osf = tc.out_size_factor
    vx, vy = tc.voxel_size[0], tc.voxel_size[1]
    w, h = tc.grid_size[0] // osf, tc.grid_size[1] // osf
    div = gaussian.true_div
    coor_x = div(div(gt_boxes[..., 0] - tc.point_cloud_range[0], vx), osf)
    coor_y = div(div(gt_boxes[..., 1] - tc.point_cloud_range[1], vy), osf)
    cx, cy = coor_x.to(torch.int32), coor_y.to(torch.int32)
    width_f = div(div(gt_boxes[..., 3], vx), osf)
    length_f = div(div(gt_boxes[..., 4], vy), osf)
    radius_f = gaussian.gaussian_radius((length_f, width_f), tc.gaussian_overlap)
    radius = torch.clamp_min(radius_f.to(torch.int32), tc.min_radius)
    ok = ((width_f > 0) & (length_f > 0)
          & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h))
    return coor_x, coor_y, cx, cy, radius, ok


def heatmap_inputs(conf: HeadConf, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_mask: torch.Tensor, geometry=None):
    """Kernel K2's operands for a batch: centres [B, K, 2] int32, radii
    [B, K] int32 and validity [B, M, K] bool over the ``M`` class maps of
    every task (map ``m`` is global class ``m``); and the maps' (H, W).
    ``geometry``: :func:`_object_geometry` of ``gt_boxes``, if at hand."""
    tc = conf.train_cfg
    _, _, cx, cy, radius, ok = geometry or _object_geometry(conf, gt_boxes)
    m = sum(t.num_class for t in conf.tasks)
    classes = torch.arange(m, device=gt_labels.device)
    valid = (gt_mask & ok)[:, None, :] & (gt_labels[:, None, :] == classes[None, :, None])
    hw = (tc.grid_size[1] // tc.out_size_factor, tc.grid_size[0] // tc.out_size_factor)
    return torch.stack([cx, cy], -1), radius, valid, hw


@torch.no_grad()
def get_targets(conf: HeadConf, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                gt_mask: torch.Tensor):
    """Training targets of a batch (``get_targets_batch`` of the JAX package).

    Args:
      gt_boxes: [B, K, 9] float32 padded boxes (x, y, z, dx, dy, dz, yaw,
        vx, vy); gt_labels: [B, K] integer global class ids; gt_mask: [B, K]
        bool.

    Returns per-task lists: heatmaps [B, C_t, H, W] float32, anno_boxes
    [B, max_objs, 10] float32, inds [B, max_objs] int64, masks
    [B, max_objs] float32. Classes no task covers produce no targets; the
    objects of a task take slots in input order, and an object that is not
    drawn (no size, off the map) or past ``max_objs`` lands in a dump slot
    that is cut off.
    """
    tc = conf.train_cfg
    max_objs = tc.max_objs * tc.dense_reg
    geometry = _object_geometry(conf, gt_boxes)
    coor_x, coor_y, cx, cy, _, ok = geometry
    centers, radii, valid, hw = heatmap_inputs(conf, gt_boxes, gt_labels, gt_mask, geometry)
    maps = gaussian.draw_heatmap(centers, radii, valid, hw)

    yaw = gt_boxes[..., 6]
    anno_all = torch.stack([
        coor_x - cx.float(), coor_y - cy.float(), gt_boxes[..., 2],
        torch.log(torch.clamp_min(gt_boxes[..., 3], 1e-12)),
        torch.log(torch.clamp_min(gt_boxes[..., 4], 1e-12)),
        torch.log(torch.clamp_min(gt_boxes[..., 5], 1e-12)),
        torch.sin(yaw), torch.cos(yaw), gt_boxes[..., 7], gt_boxes[..., 8],
    ], dim=-1)                                                    # [B, K, 10]
    ind_all = cy.long() * hw[1] + cx.long()

    b = gt_boxes.shape[0]
    heatmaps, anno_boxes, inds, masks = [], [], [], []
    for t, off in zip(conf.tasks, _task_class_offsets(conf)):
        heatmaps.append(maps[:, off:off + t.num_class])
        member = gt_mask & (gt_labels >= off) & (gt_labels < off + t.num_class)
        slot = torch.cumsum(member.long(), dim=1) - 1
        slot = torch.where(member & ok & (slot < max_objs), slot,
                           torch.full_like(slot, max_objs))
        anno = anno_all.new_zeros(b, max_objs + 1, 10).scatter_(
            1, slot[..., None].expand(-1, -1, 10), anno_all)
        ind = ind_all.new_zeros(b, max_objs + 1).scatter_(1, slot, ind_all)
        msk = anno_all.new_zeros(b, max_objs + 1).scatter_(
            1, slot, torch.ones_like(anno_all[..., 0]))
        anno_boxes.append(anno[:, :max_objs])
        inds.append(ind[:, :max_objs])
        masks.append(msk[:, :max_objs])
    return heatmaps, anno_boxes, inds, masks


def targets_on_columns(targets, lo: int, hi: int):
    """:func:`get_targets`'s lists cut to the map columns ``[lo, hi)`` of a W
    shard: the heatmaps sliced, each slot's flat cell index mapped into the
    shard and its mask cleared where the cell lies in another shard (each
    object's cell lies in one shard, so the masks summed over the shards
    count every object once)."""
    heatmaps, anno_boxes, inds, masks = targets
    w = heatmaps[0].shape[-1]
    out_inds, out_masks = [], []
    for ind, msk in zip(inds, masks):
        x = ind % w
        inside = (x >= lo) & (x < hi)
        out_inds.append(torch.where(inside, ind // w * (hi - lo) + x - lo, 0))
        out_masks.append(msk * inside.to(msk.dtype))
    return [h[..., lo:hi] for h in heatmaps], anno_boxes, out_inds, out_masks


# -------------------------------------------------------------------- losses

def gaussian_focal_loss(pred: torch.Tensor, target: torch.Tensor, avg_factor,
                        alpha: float = 2.0, gamma: float = 4.0,
                        weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mmdet GaussianFocalLoss, reduction 'mean' with ``avg_factor``;
    positives are the cells where ``target == 1``. ``weight``
    (broadcastable to ``pred``) masks eval-padding samples."""
    eps = 1e-12
    pos = (target == 1.0).to(pred.dtype)
    neg_weights = torch.pow(1.0 - target, gamma)
    pos_loss = -torch.log(pred + eps) * torch.pow(1 - pred, alpha) * pos
    neg_loss = -torch.log(1 - pred + eps) * torch.pow(pred, alpha) * neg_weights * (1 - pos)
    loss = pos_loss + neg_loss
    if weight is not None:
        loss = loss * weight
    return loss.sum() / avg_factor


def detection_loss(conf: HeadConf, targets, preds: List[Dict[str, torch.Tensor]],
                   sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Total detection loss: per task the gaussian focal loss of the
    heatmap plus ``loss_bbox_weight`` x the code-weighted L1 of the 10-dim
    box at the target cells.

    targets: :func:`get_targets`'s lists; preds: list over tasks of dicts of
    NHWC float32 maps. ``sample_mask`` [B] drops padded eval samples from
    every sum and normalizer, so a padded batch's loss equals that of its
    valid prefix. In a process group the normalizers (each task's positive
    cells and objects) are summed over the ranks in one all-reduce and
    clamped after the sum, as the JAX package's global-view step clamps the
    global count; the loss is then this rank's share of the global batch's,
    and the shares sum to it.
    """
    heatmaps, anno_boxes, inds, masks = targets
    sm = None if sample_mask is None else sample_mask.to(torch.float32)
    cw = torch.tensor(conf.train_cfg.code_weights, dtype=torch.float32,
                      device=anno_boxes[0].device)
    hm_ws, pos_counts, obj_ms = [], [], []
    for t in range(len(preds)):
        hm_tgt = heatmaps[t].permute(0, 2, 3, 1)                 # NCHW -> NHWC
        pos = (hm_tgt == 1.0).to(torch.float32)
        hm_w = None if sm is None else sm[:, None, None, None]
        hm_ws.append(hm_w)
        pos_counts.append((pos if hm_w is None else pos * hm_w).sum())
        obj_ms.append(masks[t] if sm is None else masks[t] * sm[:, None])
    counts = parallel.all_reduce_sum(torch.stack(pos_counts + [m.sum() for m in obj_ms]))
    total = 0.0
    for t, pred in enumerate(preds):
        hm_pred = clip_sigmoid(pred['heatmap'])                  # [B, H, W, C]
        hm_tgt = heatmaps[t].permute(0, 2, 3, 1)
        loss_hm = gaussian_focal_loss(hm_pred, hm_tgt, torch.clamp_min(counts[t], 1.0),
                                      weight=hm_ws[t])

        anno_pred = torch.cat([pred['reg'], pred['height'], pred['dim'], pred['rot'],
                               pred['vel']], dim=-1)             # [B, H, W, 10]
        b = anno_pred.shape[0]
        flat = anno_pred.reshape(b, -1, anno_pred.shape[-1])     # [B, HW, 10]
        gathered = torch.gather(flat, 1, inds[t][..., None].expand(-1, -1, flat.shape[-1]))

        tgt = anno_boxes[t]                                      # [B, K, 10]
        finite = torch.isfinite(tgt)
        m = obj_ms[t][..., None] * finite.to(torch.float32)
        avg = torch.clamp_min(counts[len(preds) + t], 1e-4)
        tgt_safe = torch.where(finite, tgt, 0.0)
        loss_bbox = (torch.abs(gathered - tgt_safe) * m * cw).sum() / avg
        total = total + loss_hm + conf.loss_bbox_weight * loss_bbox
    return total


def _decode_task(conf: HeadConf, pred: Dict[str, torch.Tensor]):
    """Top-k candidates of one task: (boxes [B,K,9], scores, cls, valid)."""
    bc = conf.bbox_coder
    osf, vx, vy = bc.out_size_factor, bc.voxel_size[0], bc.voxel_size[1]
    heat = torch.sigmoid(pred['heatmap'])                      # [B, H, W, C]
    b, h, w, c = heat.shape
    # NHWC flatten, channel minor: the JAX package's top-k order and ties
    scores, idx = torch.topk(heat.reshape(b, -1), min(bc.max_num, h * w * c))
    cls = idx % c
    pix = idx // c
    ys = (pix // w).float()
    xs = (pix % w).float()

    def gather(m):
        m = m.reshape(b, h * w, -1)
        return torch.gather(m, 1, pix[..., None].expand(-1, -1, m.shape[-1]))

    reg = gather(pred['reg'])
    hei = gather(pred['height'])[..., 0]
    dim = torch.exp(gather(pred['dim']))
    rot = gather(pred['rot'])
    vel = gather(pred['vel'])
    x = (xs + reg[..., 0]) * osf * vx + bc.pc_range[0]
    y = (ys + reg[..., 1]) * osf * vy + bc.pc_range[1]
    yaw = torch.atan2(rot[..., 0], rot[..., 1])
    boxes = torch.stack([x, y, hei, dim[..., 0], dim[..., 1], dim[..., 2],
                         yaw, vel[..., 0], vel[..., 1]], dim=-1)
    post = torch.tensor(bc.post_center_range, dtype=torch.float32,
                        device=boxes.device)
    center = boxes[..., :3]
    valid = ((scores > bc.score_threshold) & (center >= post[:3]).all(-1)
             & (center <= post[3:]).all(-1))
    return boxes, scores, cls, valid


def decode_boxes(conf: HeadConf, preds: List[Dict[str, torch.Tensor]]):
    """CenterPoint decode + circle NMS with fixed shapes.

    ``preds``: list over tasks of dicts of NHWC float32 maps. Returns
    (boxes [B, T*post_max, 9], scores, labels, valid), z converted to the
    bottom centre (mmdet3d CenterHead.get_bboxes). Every (batch, task) row
    goes through one NMS launch, each task with its own ``min_radius``."""
    tc = conf.test_cfg
    parts = [_decode_task(conf, p) for p in preds]
    if len({p[0].shape[1] for p in parts}) != 1:
        raise ValueError('decode_boxes: every task needs the same top-k size '
                         '(max_num <= H * W * C of each task)')
    boxes, scores, cls, valid = (torch.stack(z, dim=1) for z in zip(*parts))
    b, t, k, _ = boxes.shape                                   # [B, T, K, 9]
    if len(tc.min_radius) < t:                # the JAX decode indexes min_radius[task]
        raise ValueError(f'decode_boxes: TestCfg.min_radius holds {len(tc.min_radius)} radii '
                         f'for {t} tasks; give one a task')
    # rows (batch, task); each task's min_radius goes to the kernel by value
    keep = circle_nms.circle_nms_mask(
        boxes[..., :2].reshape(b * t, k, 2), scores.reshape(b * t, k),
        valid.reshape(b * t, k), tuple(tc.min_radius[:t])).view(b, t, k)

    # top post_max_size kept, in score order (candidates are already sorted)
    sel = torch.where(keep, scores, torch.full_like(scores, -float('inf')))
    topv, topi = torch.topk(sel, min(tc.post_max_size, k), dim=-1)
    boxes = torch.gather(boxes, 2, topi[..., None].expand(-1, -1, -1, 9))
    offs = torch.tensor(_task_class_offsets(conf), device=cls.device)
    labels = torch.gather(cls, 2, topi) + offs[:, None]
    kvalid = topv > -float('inf')
    # gravity-centre z -> bottom z (CenterHead.get_bboxes parity)
    boxes = torch.cat([boxes[..., :2], boxes[..., 2:3] - boxes[..., 5:6] / 2.0,
                       boxes[..., 3:]], dim=-1)
    m = topv.shape[-1]
    return (boxes.reshape(b, t * m, 9),
            torch.where(kvalid, topv, torch.zeros_like(topv)).reshape(b, t * m),
            labels.reshape(b, t * m),
            kvalid.reshape(b, t * m))
