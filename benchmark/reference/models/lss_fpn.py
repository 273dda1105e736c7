"""Frozen copy of the port's ``models/lss_fpn.py`` for the benchmark's reference, run
on its plain path (its kernel calls bound to their plain versions, one
process). The text below is the original's.

LSSFPN: camera images -> BEV features (NCHW, channels_last memory).

The port of ``mm_training_tpu/models/lss_fpn.py``: the image ResNet and its
SECONDFPN neck, the DepthNet, the softmax over the depth bins, the undo of
an image's horizontal flip, the depth oracle's replacement of the predicted
depth, the frustum geometry (float32) and the lift-splat onto the
head-input grid, summed over cameras; sweeps after the key frame are
concatenated on channels. The splat is the row-factorized one (kernel K4)
for a virtualized rig (``factorized_splat``, the default) and the general
one (kernel K8) for a raw rig with roll, pitch or intrinsic skew
(``factorized_splat=False``), as the JAX module chooses.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..configs import BackboneConf
from ..core.geometry import create_frustum, flat_bev_index, get_geometry, quantize_geometry
from ..ops import voxel_pooling
from .depth_net import DepthNet
from .resnet import ResNet
from .second_fpn import SECONDFPN

__all__ = ['LSSFPN']


class LSSFPN(nn.Module):
    def __init__(self, conf: BackboneConf):
        super().__init__()
        self.conf = conf
        bb, nk, dn = conf.img_backbone_conf, conf.img_neck_conf, conf.depth_net_conf
        self.img_backbone = ResNet(depth=bb.depth, in_channels=3,
                                   out_indices=bb.out_indices)
        self.img_neck = SECONDFPN(nk.in_channels, nk.out_channels, nk.upsample_strides)
        self.depth_net = DepthNet(sum(nk.out_channels), dn.mid_channels, conf.output_channels,
                                  conf.depth_channels, use_dcn=dn.use_dcn,
                                  num_blocks=dn.num_blocks)
        self._frustum: Dict[torch.device, torch.Tensor] = {}

    def bev_geometry(self) -> Tuple[Tuple[float, ...], Tuple[float, ...], Tuple[int, ...]]:
        """(voxel_coord, voxel_size, voxel_num) of the splat grid, the extra
        ``bev_pool_downsample`` folded in."""
        c = self.conf
        ds = c.bev_pool_downsample
        bounds = [(c.x_bound[0], c.x_bound[1], c.x_bound[2] * ds),
                  (c.y_bound[0], c.y_bound[1], c.y_bound[2] * ds), c.z_bound]
        voxel_size = tuple(b[2] for b in bounds)
        voxel_coord = tuple(b[0] + b[2] / 2.0 for b in bounds)
        voxel_num = tuple(int(round((b[1] - b[0]) / b[2])) for b in bounds)
        return voxel_coord, voxel_size, voxel_num

    def frustum(self, device: torch.device) -> torch.Tensor:
        """[D, fH, fW, 3] float32 on ``device``, built once per device (kept
        out of the buffers, so a bf16 cast of the model leaves it float32)."""
        if device not in self._frustum:
            c = self.conf
            self._frustum[device] = torch.from_numpy(
                create_frustum(c.d_bound, c.final_dim, c.downsample_factor)).to(device)
        return self._frustum[device]

    def _voxel_indices(self, sensor2ego: torch.Tensor, intrin: torch.Tensor) -> torch.Tensor:
        """[B, N, D, fH, fW, 3] int32 voxel of every frustum point."""
        return quantize_geometry(get_geometry(self.frustum(sensor2ego.device), sensor2ego,
                                              intrin), *self.bev_geometry()[:2])

    def splat_indices(self, sensor2ego: torch.Tensor, intrin: torch.Tensor):
        """Per camera of [B, N] matrices: the BEV cell of each (bin, column)
        from image row 0 [B*N, D, fW] int32 (``n_cells`` = off the grid) and
        the z-range mask [B*N, D, fH, fW] bool. With zero roll and pitch a
        frustum point's (x, y) does not depend on its row."""
        gidx = self._voxel_indices(sensor2ego, intrin)
        nx, ny, nz = self.bev_geometry()[2]
        d, fh, fw = gidx.shape[2:5]
        x, y = gidx[:, :, :, 0, :, 0], gidx[:, :, :, 0, :, 1]
        valid_xy = (x >= 0) & (x < nx) & (y >= 0) & (y < ny)
        flat_xy = torch.where(valid_xy, y * nx + x, nx * ny).to(torch.int32)
        z = gidx[..., 2]
        zvalid = (z >= 0) & (z < nz)
        return flat_xy.reshape(-1, d, fw), zvalid.reshape(-1, d, fh, fw)

    def raw_splat_indices(self, sensor2ego: torch.Tensor, intrin: torch.Tensor) -> torch.Tensor:
        """Per camera of [B, N] matrices: the BEV cell of every frustum
        point [B*N, D, fH*fW] int32, ``n_cells`` where it is off the grid in
        x, y or z (the raw-rig splat's index; any rig)."""
        gidx = self._voxel_indices(sensor2ego, intrin)
        d, fh, fw = gidx.shape[2:5]
        return flat_bev_index(gidx, self.bev_geometry()[2]).reshape(-1, d, fh * fw)

    def _forward_single_sweep(self, imgs: torch.Tensor, sensor2ego: torch.Tensor,
                              intrin: torch.Tensor, flipped: Optional[torch.Tensor],
                              depth_oracle: Optional[torch.Tensor],
                              keep: Optional[torch.Tensor] = None):
        """imgs [B, N, H, W, 3] (compute dtype), matrices [B, N, 4, 4]
        float32, flipped [B*N] bool or None (no image flipped),
        depth_oracle [B*N, fH, fW, D] or None, keep: ASPP's dropout mask
        [B*N, mid, fH, fW] in train mode. Returns (bev [B, ny, nx, C] NHWC
        in the compute dtype, depth [B*N, D, fH, fW], the softmax as the
        images came, flips not undone)."""
        b, n = imgs.shape[:2]
        d_ch, c_out = self.conf.depth_channels, self.conf.output_channels
        x = imgs.reshape(b * n, *imgs.shape[2:]).permute(0, 3, 1, 2)   # NCHW view
        feat = self.depth_net(self.img_neck(self.img_backbone(x)), keep)   # [BN, D+C, fH, fW]
        depth = feat[:, :d_ch].softmax(dim=1)
        ctx = feat[:, d_ch:d_ch + c_out]
        lift = depth
        if flipped is not None:     # undo an image's flip before the lift
            sel = flipped[:, None, None, None]
            lift = torch.where(sel, depth.flip(-1), depth)
            ctx = torch.where(sel, ctx.flip(-1), ctx)
        if depth_oracle is not None:
            # max(oracle) > 0 holds wherever a label is one-hot, so the
            # oracle replaces the predicted depth there
            oracle = depth_oracle.permute(0, 3, 1, 2)
            fg = oracle.amax(dim=1, keepdim=True) > 0.0
            lift = torch.where(fg, oracle.to(depth.dtype), lift)
        nx, ny, _ = self.bev_geometry()[2]
        if self.conf.factorized_splat:
            flat_xy, zvalid = self.splat_indices(sensor2ego, intrin)
            bev = voxel_pooling.lift_splat_factorized(lift, ctx.permute(0, 2, 3, 1), flat_xy,
                                                      zvalid, nx * ny)     # [BN, G, C]
        else:
            # [BN, D, P] and [BN, P, C] views of the path's layouts: no copy
            flat = self.raw_splat_indices(sensor2ego, intrin)
            bev = voxel_pooling.lift_splat(lift.flatten(2), ctx.permute(0, 2, 3, 1).flatten(1, 2),
                                           flat, nx * ny)                  # [BN, G, C]
        bev = bev.reshape(b, n, ny * nx, c_out).sum(dim=1)
        return bev.reshape(b, ny, nx, c_out), depth

    def forward(self, imgs: torch.Tensor, sensor2ego: torch.Tensor, intrin: torch.Tensor,
                flipped: Optional[torch.Tensor] = None,
                depth_oracle: Optional[torch.Tensor] = None,
                dropout: Optional[Sequence[torch.Tensor]] = None):
        """imgs [B, S, N, H, W, 3] normalised, in the compute dtype;
        sensor2ego, intrin [B, S, N, 4, 4] float32; flipped [B*S*N] bool or
        None; depth_oracle [B*N, fH, fW, D] (key frame) or None; dropout: in
        train mode ASPP's keep masks, one [B*N, mid, fH, fW] bool a sweep
        (the JAX module draws a mask a call).

        Sweeps after the key frame run without a gradient (the JAX
        package's ``stop_gradient``) but in the same mode: in train mode
        their BatchNorms take batch statistics and update the running
        ones, after the key frame's, in sweep order.

        Returns (bev [B, ny, nx, S*C] NHWC, key-frame depth [B*N, D, fH, fW])."""
        b, s, n = imgs.shape[:3]
        flips = None if flipped is None else flipped.reshape(b, s, n)
        bevs: List[torch.Tensor] = []
        key_depth = None
        for si in range(s):
            f = None if flips is None else flips[:, si].reshape(-1)
            with torch.set_grad_enabled(torch.is_grad_enabled() and si == 0):
                bev, depth = self._forward_single_sweep(
                    imgs[:, si], sensor2ego[:, si], intrin[:, si], f,
                    depth_oracle if si == 0 else None, None if dropout is None else dropout[si])
            bevs.append(bev)
            if si == 0:
                key_depth = depth
        bev = bevs[0] if s == 1 else torch.cat(bevs, dim=-1)
        return bev, key_depth
