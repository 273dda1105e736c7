"""Test-time augmentation: the 4-way flip ensemble.

The port of ``mm_training_tpu/training/tta.py``, the re-design of the
reference's ``test_time_augment`` (exps/mm_training_aim.py:424-489): the
model runs on the 4 (x_flip, y_flip) sign combinations of the point cloud,
each prediction map is un-flipped back to the canonical frame, and the four
are averaged: heatmaps in sigmoid space, dims in exp space, velocities
sign-corrected, rotations angle-corrected (x flip: pi - rot; y flip: -rot),
then turned back into logits and logs so the standard decode applies.

As in the JAX package (its documented deviations from the reference):
  * the x-flip yaw correction is the reflection ``pi - rot``, not the
    reference's rotation ``rot - pi`` (:475), which cancels the sine of
    every yaw when the four members are averaged;
  * the un-flip is an axis flip of the NHWC map (H is y, W is x), exact for
    the symmetric BEV grid;
  * the camera inputs are not flipped (the reference clones but never flips
    the images), and the depth oracle is the caller's, computed once from
    the unflipped points;
  * the sub-cell ``reg`` offsets are not corrected after a flip (the
    reference's quirk, kept so the decode matches).

The four forwards run as the JAX package runs them: the camera branch
computes the same result in each. On a model axis each member's maps are
gathered from the model peers' W shards before the un-flip.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from .. import parallel
from ..parallel import spatial

__all__ = ['tta_forward']

_EPS = 1e-5
_FLIPS = ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0))


def _flip_points(points: Optional[torch.Tensor], x_flip: float, y_flip: float):
    if points is None or (x_flip > 0 and y_flip > 0):
        return points
    return torch.cat([points[..., :1] * x_flip, points[..., 1:2] * y_flip, points[..., 2:]], -1)


def _unflip_map(m: torch.Tensor, x_flip: float, y_flip: float) -> torch.Tensor:
    """NHWC map: H is the y axis, W is the x axis."""
    if x_flip < 0:
        m = m.flip(2)
    if y_flip < 0:
        m = m.flip(1)
    return m


def _correct_pred(pred: Dict[str, torch.Tensor], x_flip: float, y_flip: float):
    out = {}
    for key, v in pred.items():
        v = _unflip_map(v, x_flip, y_flip)
        if key == 'heatmap':
            v = torch.sigmoid(v)
        elif key == 'dim':
            v = torch.exp(v)
        elif key == 'vel':
            v = torch.stack([v[..., 0] * x_flip, v[..., 1] * y_flip], dim=-1)
        elif key == 'rot':
            rot = torch.atan2(v[..., 0], v[..., 1])
            if x_flip < 0:
                rot = math.pi - rot   # reflection, NOT rotation (see module doc)
            if y_flip < 0:
                rot = -rot
            v = torch.stack([torch.sin(rot), torch.cos(rot)], dim=-1)
        out[key] = v
    return out


def tta_forward(model: nn.Module, weights: Optional[Dict[str, torch.Tensor]],
                points: Optional[torch.Tensor], point_mask: Optional[torch.Tensor],
                cam: Dict[str, Any], return_depth: bool = True
                ) -> Tuple[List[Dict[str, torch.Tensor]], Any]:
    """The 4-way flip-ensembled forward of ``model`` (through
    ``torch.func.functional_call`` on ``weights`` when given): (the head's
    float32 preds in the canonical logit/log parameterization, a drop-in for
    ``decode_boxes`` and the loss; the depth of the identity member, None
    without ``return_depth``). ``cam`` holds the camera keyword arguments,
    the depth oracle among them, passed unchanged to every member."""
    acc = None
    depth = None
    for x_flip, y_flip in _FLIPS:
        args = (_flip_points(points, x_flip, y_flip), point_mask)
        kw = dict(cam, return_depth=return_depth)
        if weights is None:
            out = model(*args, **kw)
        else:
            out = torch.func.functional_call(model, weights, args, kw)
        preds, dp = out if return_depth else (out, None)
        # the un-flip reverses W: on a model axis it takes the whole maps
        preds = spatial.gather_w(preds, parallel.model_axis())
        corrected = [_correct_pred({k: v.float() for k, v in p.items()}, x_flip, y_flip)
                     for p in preds]
        if acc is None:
            acc = corrected
            depth = dp   # the identity (1, 1) member
        else:
            acc = [{k: a[k] + c[k] for k in a} for a, c in zip(acc, corrected)]

    out = []
    for task in acc:
        t = {k: v / 4.0 for k, v in task.items()}
        hm = t['heatmap'].clamp(_EPS, 1.0 - _EPS)
        t['heatmap'] = torch.log(hm) - torch.log1p(-hm)   # inverse sigmoid
        t['dim'] = torch.log(t['dim'].clamp_min(1e-12))
        out.append(t)
    return out, depth
