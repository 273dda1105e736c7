"""CenterPoint-style BEV detection head and box decode.

The port of ``mm_training_tpu/models/centerpoint_head.py`` for serving:
``SeparateHead`` and ``BEVDepthHead`` (ResNet-18 trunk -> SECONDFPN ->
shared conv -> per-task branches), and ``decode_boxes`` (top-k, box
decode, post-centre range, circle NMS through kernel K3, top
``post_max_size`` survivors). Targets and losses arrive with the training
slice. Names follow mmdet3d (``trunk``, ``neck``, ``shared_conv``,
``task_heads.{t}.{head}.{i}``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..configs import HeadConf
from ..ops import circle_nms
from .resnet import ConvBN, ResNet
from .second_fpn import SECONDFPN

__all__ = ['SeparateHead', 'BEVDepthHead', 'decode_boxes']


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

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name)(x) for name in self.head_names}


class BEVDepthHead(nn.Module):
    """BEV trunk + neck + CenterPoint task heads.

    Input [B, C, H/8, W/8] (channels_last); output a list over tasks of
    dicts of NHWC [B, H/4, W/4, ch] maps, the JAX package's layout (views of
    the channels_last results, no copy)."""

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

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        shared = self.shared_conv(self.neck(self.trunk(x)))
        return [{k: v.permute(0, 2, 3, 1) for k, v in head(shared).items()}
                for head in self.task_heads]


def _task_class_offsets(conf: HeadConf) -> List[int]:
    offs, flag = [], 0
    for t in conf.tasks:
        offs.append(flag)
        flag += t.num_class
    return offs


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
    thresh = torch.tensor([tc.min_radius[i] for i in range(t)],
                          dtype=torch.float32, device=boxes.device).repeat(b)
    keep = circle_nms.circle_nms_mask(
        boxes[..., :2].reshape(b * t, k, 2).contiguous(), scores.reshape(b * t, k),
        valid.reshape(b * t, k), thresh).view(b, t, k)

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
