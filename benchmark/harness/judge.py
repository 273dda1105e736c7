"""The numbers that decide ``correct``: what the program (or the control in
its place) produced, against the plain reference, each beside its limit.

Training. A leaf's gap is the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger. ``loss_gap``: the worst of each checked step's loss
and its detection and depth parts, relative; ``grad_gap``: the median
leaf's gap of the first gradient as the optimizer holds it after one step
(its first moment over 1 - b1); ``change_gap``: the worst leaf's gap of
each parameter's change after the checked steps, leaves whose reference
gradient is under a thousandth of the median leaf's left out (they move
under Adam by round-off alone); ``bn_gap``: the worst gap of the BatchNorm
running statistics after the checked steps. The first gradient is taken
at the median leaf, not the worst: the worst is the image stem's
BatchNorm bias, whose gradient is a sum over 3.6 million pixels that
cancels to a two-thousandth of its absolute sum, so that bf16 rounding
sets it at four to five times the float32 value, in the program and in the
reference run in bf16 alike (PERF.md).

Predict, for every kept box of the checked calls, against the reference's
decode of every cell of the same frame, task and class, matched to the
nearest in centre, log sizes and score (:func:`_features`):
``center_gap``, the distance (m) to that box; ``score_gap``, the largest
score gap to it; ``attr_gap_p99``, the 99th percentile over the kept
boxes of each box's largest gap of its other outputs (z and velocity
relative to max(1, |reference|), the sizes' logarithms, and the yaw's
wrapped angle times the reference's rotation vector's length, which the
yaw is ill-conditioned without); the largest of these, a widest gap that
sound runs and the control do not hold apart, is logged. And the kept set, both ways,
by the decode's own rule (top ``max_num`` candidates by score, the score
threshold and the centre range, circle NMS with the task's radius, the
``post_max_size`` best survivors) applied to the reference's cells with
every score allowed to move by ``score_gap``'s limit and every centre by
``center_gap``'s (:func:`_fates`): ``missed_boxes``, the boxes the rule
keeps for sure that the program did not keep (or the boxes it kept short
of the survivors the rule guarantees); ``extra_boxes``, the program's boxes
whose cell the rule leaves out for sure (or that two boxes share);
``nms_pairs``, the pairs of the program's kept boxes of one frame and task
closer than the task's NMS radius.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

TRAIN_NUMBERS = ('loss_gap', 'grad_gap', 'change_gap', 'bn_gap')
PREDICT_NUMBERS = ('center_gap', 'score_gap', 'attr_gap_p99', 'missed_boxes', 'extra_boxes',
                   'nms_pairs')


def leaf_gaps(prog: Sequence[float], ref: Sequence[float], keep=None) -> np.ndarray:
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    gaps = np.abs(prog - ref) / np.maximum(ref, np.median(ref))
    if not np.all(np.isfinite(prog)):
        gaps = np.full_like(gaps, math.inf)
    return gaps if keep is None else gaps[keep]


def worst_leaves(prog, ref, names, n: int = 4, keep=None):
    """The ``n`` leaves with the largest gaps: (name, program, reference)."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    gaps = np.abs(prog - ref) / np.maximum(ref, np.median(ref))
    if keep is not None:
        gaps = np.where(keep, gaps, -1)
    return [(names[i], float(prog[i]), float(ref[i])) for i in np.argsort(-gaps)[:n]]


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Readings: ``losses`` [steps][3], ``grad_norms``, ``change_norms``
    (per parameter), ``bn_norms`` (per running statistic)."""
    lp, lr = np.asarray(prog['losses'], np.float64), np.asarray(ref['losses'], np.float64)
    scale = np.where(np.abs(lr) > 0, np.abs(lr), 1.0)
    if not np.all(np.isfinite(lp)):
        loss_gap = math.inf
    else:
        loss_gap = float((np.abs(lp - lr) / scale).max())
    g = np.asarray(ref['grad_norms'], np.float64)
    moved = g >= 1e-3 * np.median(g)
    return {'loss_gap': loss_gap,
            'grad_gap': float(np.median(leaf_gaps(prog['grad_norms'], ref['grad_norms']))),
            'change_gap': float(leaf_gaps(prog['change_norms'], ref['change_norms'],
                                          moved).max()),
            'bn_gap': float(leaf_gaps(prog['bn_norms'], ref['bn_norms']).max())}


def _wrap(a: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def dense_decode(head_conf, maps: List[Dict[str, torch.Tensor]]):
    """Every cell's box of every class, as the decode forms a candidate:
    per task (boxes [B, H*W*C, 10]: the decode's 9 with the bottom z, and
    the rotation vector's length; scores; global labels)."""
    bc = head_conf.bbox_coder
    osf, vx, vy = bc.out_size_factor, bc.voxel_size[0], bc.voxel_size[1]
    boxes, scores, labels, off = [], [], [], 0
    for t, p in enumerate(maps):
        heat = torch.sigmoid(p['heatmap'].float())
        b, h, w, c = heat.shape
        ys, xs = torch.meshgrid(torch.arange(h, device=heat.device, dtype=torch.float32),
                                torch.arange(w, device=heat.device, dtype=torch.float32),
                                indexing='ij')
        reg, hei = p['reg'].float(), p['height'].float()[..., 0]
        dim, rot, vel = torch.exp(p['dim'].float()), p['rot'].float(), p['vel'].float()
        x = (xs + reg[..., 0]) * osf * vx + bc.pc_range[0]
        y = (ys + reg[..., 1]) * osf * vy + bc.pc_range[1]
        yaw = torch.atan2(rot[..., 0], rot[..., 1])
        box = torch.stack([x, y, hei - dim[..., 2] / 2, dim[..., 0], dim[..., 1], dim[..., 2],
                           yaw, vel[..., 0], vel[..., 1], rot.norm(dim=-1)], -1)
        box = box[:, :, :, None, :].expand(b, h, w, c, 10).reshape(b, -1, 10)
        boxes.append(box)
        scores.append(heat.reshape(b, -1))
        labels.append((torch.arange(c, device=heat.device) + off).repeat(h * w)[None].expand(b, -1))
        off += c
    return boxes, scores, labels


def _features(boxes: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """What a kept box is matched to its cell by: centre, log sizes and
    score (x 10), so that a neighbouring cell whose centre lies as near does
    not pass for it. Not z: with random weights it is minus half of a height
    of thousands of metres, whose gap in metres would outweigh the rest."""
    b = boxes.double()
    return torch.cat([b[:, :2], b[:, 3:6].log(), 10 * scores.double()[:, None]], 1)


def _count_above(sorted_asc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """How many values of ``sorted_asc`` exceed each of ``x``."""
    return sorted_asc.numel() - torch.searchsorted(sorted_asc, x, right=True)


def _fates(boxes: torch.Tensor, scores: torch.Tensor, conf, radius2: float,
           ds: float, dc: float):
    """What the decode's rule does with each cell of one frame and task
    when every score may move by ``ds`` and every centre by ``dc``:
    (kept for sure, left out for sure, survivors of the NMS for sure), as
    masks over the cells. ``boxes``: the dense decode's [N, 10]."""
    bc, post_max = conf.bbox_coder, conf.test_cfg.post_max_size
    n = scores.numel()
    k = min(bc.max_num, n)
    s = scores.double()
    asc = torch.sort(s).values
    # among the top k candidates whatever the moves, or possibly
    sure_in = _count_above(asc, s - 2 * ds) <= k
    maybe_in = _count_above(asc, s + 2 * ds) < k
    centre = torch.cat([boxes[:, :2], boxes[:, 2:3] + boxes[:, 5:6] / 2], 1).double()
    lo = torch.tensor(bc.post_center_range[:3], dtype=torch.float64, device=s.device)
    hi = torch.tensor(bc.post_center_range[3:], dtype=torch.float64, device=s.device)

    def inside(m):
        return ((centre >= lo + m) & (centre <= hi - m)).all(1)
    sure_valid = (s > bc.score_threshold + ds) & inside(dc)
    maybe_valid = (s > bc.score_threshold - ds) & inside(-dc)
    maybe = torch.nonzero(maybe_in & maybe_valid).squeeze(1)
    sm, sure_m = s[maybe], (sure_in & sure_valid)[maybe]
    d = torch.cdist(centre[maybe, :2], centre[maybe, :2])
    r = math.sqrt(radius2)
    other = ~torch.eye(len(maybe), dtype=torch.bool, device=s.device)
    above = sm[None, :] > sm[:, None] - 2 * ds            # [j, i]: i may outrank j
    clearly_above = sm[None, :] > sm[:, None] + 2 * ds    # [j, i]: i outranks j for sure
    # no candidate that may outrank it may come within the radius
    survivor = sure_m & ~(other & above & (d <= r + 2 * dc)).any(1)
    # within the radius of a sure survivor that outranks it for sure
    suppressed = (clearly_above & survivor[None, :] & (d < r - 2 * dc)).any(1)
    possible = ~suppressed
    kept_m = survivor & ((other & above & possible[None, :]).sum(1) < post_max)
    out_m = suppressed | ((clearly_above & survivor[None, :]).sum(1) >= post_max)
    kept = torch.zeros(n, dtype=torch.bool, device=s.device)
    out = torch.ones(n, dtype=torch.bool, device=s.device)
    surv = torch.zeros(n, dtype=torch.bool, device=s.device)
    kept[maybe], out[maybe], surv[maybe] = kept_m, out_m, survivor
    return kept, out, surv


def predict_numbers(head_conf, outputs, refs, limits: Dict[str, float],
                    log: Callable[[str], None] = lambda s: None) -> Dict[str, float]:
    """``outputs``: per checked call (boxes [B, T*K, 9], scores, labels,
    valid) on the host; ``refs``: per checked call the reference's (decoded
    outputs, float32 pred maps); the maps are what the boxes are judged by,
    ``limits``' ``score_gap`` and ``center_gap`` how far a cell's score and
    centre may move in the kept set's rule."""
    worst = dict.fromkeys(PREDICT_NUMBERS, 0.0)
    tasks = len(head_conf.tasks)
    ds, dc = limits['score_gap'], limits['center_gap']
    post_max = head_conf.test_cfg.post_max_size
    sure_kept = ref_kept = 0
    z_gap = 0.0
    attrs = [torch.zeros(0, dtype=torch.float64)]
    for (boxes, scores, labels, valid), ((_, _, _, rvalid), maps) in zip(outputs, refs):
        rboxes, rscores, rlabels = dense_decode(head_conf, maps)
        b = boxes.shape[0]
        k = boxes.shape[1] // tasks
        for i in range(b):
            for t in range(tasks):
                sl = slice(t * k, (t + 1) * k)
                v = valid[i, sl].bool()
                dev = rboxes[t].device
                pb, ps, pl = boxes[i, sl][v].to(dev), scores[i, sl][v].to(dev), labels[i, sl][v].to(dev)
                if not (torch.isfinite(pb).all() and torch.isfinite(ps).all()):
                    return dict.fromkeys(PREDICT_NUMBERS, math.inf)
                rb, rs, rl = rboxes[t][i], rscores[t][i], rlabels[t][i]
                radius2 = float(head_conf.test_cfg.min_radius[t])
                kept, out, surv = _fates(rb, rs, head_conf, radius2, ds, dc)
                cell = torch.full((len(pb),), -1, dtype=torch.long, device=dev)
                for lab in pl.unique():
                    sel, rsel = pl == lab, rl == lab
                    if not rsel.any():
                        return dict.fromkeys(PREDICT_NUMBERS, math.inf)
                    p, r = _features(pb[sel], ps[sel]), _features(rb[rsel], rs[rsel])
                    j = torch.cdist(p, r, p=1).argmin(1)       # the box's own cell
                    cell[sel] = torch.nonzero(rsel).squeeze(1)[j]
                    near, q = rb[rsel][j].double(), pb[sel].double()
                    worst['center_gap'] = max(worst['center_gap'],
                                              float((q[:, :2] - near[:, :2]).norm(dim=1).max()))
                    worst['score_gap'] = max(worst['score_gap'],
                                             float((ps[sel] - rs[rsel][j]).abs().max()))
                    rel = ((q[:, [2, 7, 8]] - near[:, [2, 7, 8]]).abs()
                           / near[:, [2, 7, 8]].abs().clamp_min(1))
                    logs = (q[:, 3:6].log() - near[:, 3:6].log()).abs()
                    yaw = _wrap(q[:, 6] - near[:, 6]).abs() * near[:, 9]
                    attr = torch.cat([rel, logs, yaw[:, None]], 1)
                    attrs.append(attr.max(1).values.cpu())
                    zc = (q[:, 2] + q[:, 5] / 2 - near[:, 2] - near[:, 5] / 2).abs()
                    z_gap = max(z_gap, float(zc.max()))
                matched = torch.zeros_like(kept)
                matched[cell] = True
                need = min(post_max, int(surv.sum()))
                worst['missed_boxes'] += max(int((kept & ~matched).sum()), need - len(pb))
                worst['extra_boxes'] += int(out[cell].sum()) + len(pb) - int(matched.sum())
                c = pb[:, :2].double()
                close = torch.cdist(c, c).square() < radius2 * (1 - 1e-6)
                worst['nms_pairs'] += int(torch.triu(close, 1).sum())
                sure_kept += int(kept.sum())
                ref_kept += int(rvalid[i, sl].sum())
    attr = torch.cat(attrs)
    if len(attr):
        worst['attr_gap_p99'] = float(torch.quantile(attr, 0.99))
    log(f'kept set: {sure_kept} boxes kept for sure of the reference\'s {ref_kept}; '
        f'largest centre z gap of a kept box {z_gap} m; largest attribute gap '
        f'{float(attr.max()) if len(attr) else 0.0}')
    return worst


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and within its limit (a number without a limit
    is reported, not judged)."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= lim for k, lim in limits.items())
