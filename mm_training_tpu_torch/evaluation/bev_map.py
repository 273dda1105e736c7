"""BEV mAP evaluator.

The port's copy of ``mm_training_tpu/evaluation/bev_map.py``, its numpy
arithmetic unchanged: axis-aligned-BEV-box AP at IoU 0.3 within x <= 204.8
m, with Hungarian-on-score matching (default), PR-curve AUC and 11-point
interpolated AP, recall/precision at the optimal operating point, class
accuracy over matched pairs, and AOS yaw similarity; the reference's
``MAPCalculator.update`` / ``compute_bev`` surface (utils/eval.py:666-723),
so the trainer logs the same metric names.

Array backend: the box/sort/merge math goes through ``utils/universal``,
which takes numpy arrays or torch tensors (decode outputs on the card) and
computes in numpy. The Hungarian assignment (scipy) and the PR-curve
scalar math are host-side.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..utils import universal as U

__all__ = ['MAPCalculator', 'evaluate_ap', 'box_iou_aabb', 'obj2arrays_bev',
           'cosine_similarity']


# ------------------------------------------------------------------ geometry

def box_iou_aabb(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """IoU of axis-aligned [x1,y1,x2,y2] boxes; [N,4] x [M,4] -> [N,M]
    (utils/eval.py:147-174)."""
    n, m = b1.shape[0], b2.shape[0]
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float32)
    lt = U.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = U.minimum(b1[:, None, 2:4], b2[None, :, 2:4])
    wh = U.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    a2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    iou = inter / U.maximum(a1[:, None] + a2[None, :] - inter, 1e-12)
    return U.to_numpy(iou)  # the Hungarian matchers are host-side scipy


# ------------------------------------------------------------------ matchers

def assign_scoresort(ious: np.ndarray, scores=None, iou_th=0.3):
    """VOC-style greedy matching in prediction order (eval.py:19-44)."""
    gt_assign, pred_assign = {}, {}
    if 0 in ious.shape:
        return gt_assign, pred_assign
    n_pred = ious.shape[1]
    for i in range(n_pred):
        for j in np.argsort(ious[:, i])[::-1]:
            if j in gt_assign:
                continue
            if ious[j, i] < iou_th:
                continue
            gt_assign[j] = [i]
            pred_assign[i] = [j]
            break
    return gt_assign, pred_assign


def assign_hunscore(ious: np.ndarray, scores: np.ndarray, iou_th=0.3):
    """Filter candidates by IoU, then Hungarian on (1 - score)
    (eval.py:49-79) — the reference default."""
    gt_assign, pred_assign = {}, {}
    if 0 in ious.shape:
        return gt_assign, pred_assign
    cand = ious >= iou_th
    big = np.finfo(np.float32).max
    costs = np.where(cand, 1.0 - scores[None, :].astype(np.float32), big)
    rows, cols = linear_sum_assignment(costs)
    for r, c in zip(rows, cols):
        if costs[r, c] <= 1.0:
            gt_assign.setdefault(r, []).append(c)
            pred_assign.setdefault(c, []).append(r)
    return gt_assign, pred_assign


def assign_huniou(ious: np.ndarray, scores=None, iou_th=0.3):
    """Hungarian on (1 - IoU) (eval.py:83-103)."""
    gt_assign, pred_assign = {}, {}
    if 0 in ious.shape:
        return gt_assign, pred_assign
    costs = 1.0 - ious
    rows, cols = linear_sum_assignment(costs)
    for r, c in zip(rows, cols):
        if costs[r, c] <= 1.0 - iou_th:
            gt_assign.setdefault(r, []).append(c)
            pred_assign.setdefault(c, []).append(r)
    return gt_assign, pred_assign


def center_distance_cost(b1: np.ndarray, b2: np.ndarray,
                         distance_thr: float) -> np.ndarray:
    """Gated center-distance cost between ltrb AABBs; [N,4] x [M,4] -> [N,M]
    (eval.py:743-766 cost_matrix_by_dist). Pairs beyond the threshold get a
    huge cost so the Hungarian never prefers them."""
    n, m = b1.shape[0], b2.shape[0]
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float32)
    c1 = U.to_numpy((b1[:, :2] + b1[:, 2:4]) / 2.0)
    c2 = U.to_numpy((b2[:, :2] + b2[:, 2:4]) / 2.0)
    cost = np.linalg.norm(c1[:, None, :] - c2[None, :, :], axis=-1)
    return np.where(cost > distance_thr, 999999.0, cost).astype(np.float32)


def assign_distance(cost: np.ndarray, scores=None, distance_thr=2.0):
    """Hungarian on a center-distance cost matrix (eval.py:769-784)."""
    gt_assign, pred_assign = {}, {}
    if 0 in cost.shape:
        return gt_assign, pred_assign
    rows, cols = linear_sum_assignment(cost)
    for r, c in zip(rows, cols):
        if cost[r, c] < distance_thr:
            gt_assign[r] = [c]
            pred_assign[c] = [r]
    return gt_assign, pred_assign


_ASSIGN = {'scoresort': assign_scoresort, 'hunscore': assign_hunscore,
           'huniou': assign_huniou, 'distance': assign_distance}


# ------------------------------------------------------------------- AP math

def calc_recall_precision(correct, n_gt: int):
    cum = U.to_numpy(U.to_float(U.cumsum(correct)))
    recs = cum / max(n_gt, 1e-12)
    precs = cum / np.arange(1, len(correct) + 1)
    return recs, precs


def fix_zigzag(precs: np.ndarray) -> np.ndarray:
    return np.maximum.accumulate(precs[::-1])[::-1]


def calc_ap_auc(recs: np.ndarray, precs: np.ndarray) -> float:
    if len(recs) == 0:
        return 0.0
    mprec = np.concatenate([[0.0], precs, [0.0]])
    mrec = np.concatenate([[0.0], recs, [1.0]])
    pf = fix_zigzag(mprec)
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * pf[i + 1]))


def calc_interp_precision(recall, precision, recall_values):
    out = []
    for r in recall_values:
        sel = recall >= r
        out.append(float(np.max(precision[sel])) if np.any(sel) else 0.0)
    return np.asarray(out, np.float32)


def calc_ap_interp(recall, precision, n_inter=11) -> float:
    rv = np.linspace(0.0, 1.0, n_inter)
    return float(np.sum(calc_interp_precision(recall, precision, rv)) / n_inter)


def calc_optimal_op_index(recs, precs, scores):
    """Index maximizing precision*recall (eval.py:286-307)."""
    if len(recs) == 0:
        return -1
    pr = recs * precs
    idx = pr == np.max(pr)
    offs = np.where(idx)[0]
    if len(offs) == 1:
        return offs[0]
    cand = scores[idx]
    max_i = np.where(cand == np.max(cand))[0][-1]
    min_i = np.where(cand == np.min(cand))[0][0]
    if max_i == min_i or cand[max_i] == cand[min_i]:
        return offs[min_i]
    return (offs[max_i], offs[min_i])


# ------------------------------------------------------------ frame adapters

def obj2arrays_bev(objects: np.ndarray, classes, scores=None, name=None,
                   needs_score=False, x_range=200.0) -> Dict[str, np.ndarray]:
    """[K, 7+] boxes -> dict of AABB bev boxes/class/yaw/img_name, filtered to
    |x| <= x_range (eval.py:626-663; yaw is reported in degrees there)."""
    objects = U.to_numpy(objects).astype(np.float32)
    objects = objects.reshape(-1, objects.shape[-1] if len(objects) else 9)
    if len(objects) == 0:
        out = {'class': np.zeros((0,), np.int64),
               'bbox': np.zeros((0, 4), np.float32),
               'img_name': np.zeros((0,), object),
               'yaw': np.zeros((0,), np.float32)}
        if needs_score:
            out['score'] = np.zeros((0,), np.float32)
        return out
    x, y = objects[:, 0], objects[:, 1]
    l, w = objects[:, 3], objects[:, 4]
    bbox = U.stack([x - l / 2, y - w / 2, x + l / 2, y + w / 2], -1)
    yaw = np.degrees(objects[:, 6])
    valid = U.abs(x) <= x_range
    out = {'class': U.masked_select(U.to_numpy(classes), valid),
           'bbox': U.masked_select(bbox, valid).astype(np.float32),
           'img_name': np.asarray([name] * len(objects), object)[valid],
           'yaw': U.masked_select(yaw, valid).astype(np.float32)}
    if needs_score:
        out['score'] = U.masked_select(
            U.to_numpy(scores).astype(np.float32), valid)
    return out


def _sort_by(d: Dict[str, np.ndarray], key: str, desc=True):
    idx = U.to_numpy(U.argsort(d[key], axis=-1))
    if desc:
        idx = idx[::-1]
    return {k: U.index_select(v, idx) for k, v in d.items()}


def _merge(frames: List[Dict[str, np.ndarray]]):
    keys = frames[0].keys()
    return {k: U.concatenate([f[k] for f in frames], 0) for k in keys}


# ----------------------------------------------------------------- evaluator

def evaluate_ap(gts: List[Dict], preds: List[Dict], eval_class=None,
                iou_th=0.3, assign_method='hunscore', val_field=None,
                sim_func=None, val_metric_name=None, n_inter=11,
                calc_op=True, return_curves=False,
                unlabeled_classes=()) -> Dict[str, float]:
    """Dataset-level AP (eval.py:319-594 core path). With ``return_curves``
    the result carries the raw PR curve under 'curves' — unlike the
    reference, whose return_curves branch hits the ``res.update({set})``
    bug (eval.py:584-592) and never actually returns them.

    ``unlabeled_classes`` are ignored AFTER association (eval.py:451-460):
    their GT, predictions matched to that GT, and predictions of those
    classes all drop out of the PR statistics — GT knowledge is used for
    the filtering, exactly like the reference.

    ``assign_method='distance'`` matches on gated center distance with
    ``iou_th`` as the distance threshold in metres (the reference pairs
    assign_gt_det_distance with a cost_matrix_by_dist iou_func)."""
    gts = [dict(g) for g in gts]
    preds = [_sort_by(dict(p), 'score') for p in preds]

    if eval_class is not None:
        def filt(d):
            sel = U.to_numpy(d['class'] == eval_class)
            return {k: U.masked_select(v, sel) for k, v in d.items()}
        gts = [filt(g) for g in gts]
        preds = [filt(p) for p in preds]

    assign = _ASSIGN[assign_method]
    for gt, pred in zip(gts, preds):
        if assign_method == 'distance':
            # Hungarian MINIMIZES this matrix: center distance, not IoU
            ious = center_distance_cost(gt['bbox'], pred['bbox'], iou_th)
            tiebreak = -ious  # smaller distance = better match
        else:
            ious = box_iou_aabb(gt['bbox'], pred['bbox'])
            tiebreak = ious
        score = pred.get('score')
        score = None if score is None else U.to_numpy(score)
        _, pred_assigns = assign(ious, score, iou_th)
        pa = -np.ones(len(pred['bbox']), np.int32)
        for pk, lst in pred_assigns.items():
            if len(lst) == 1:
                pa[pk] = lst[0]
            elif len(lst) > 1:
                pa[pk] = lst[int(np.argmax(tiebreak[lst, pk]))]
        correct = pa != -1
        pred['correct'] = correct
        if val_field is not None:
            gt_vals = U.to_numpy(gt[val_field])
            vals = np.zeros(len(pred['bbox']), dtype=gt_vals.dtype)
            vals[correct] = gt_vals[pa[correct]]
            pred['assigned_' + val_field] = vals

        if len(unlabeled_classes) > 0:
            ignore_gt = np.isin(U.to_numpy(gt['class']), unlabeled_classes)
            ignore_pred = np.isin(U.to_numpy(pred['class']), unlabeled_classes)
            # predictions matched to an ignored GT are ignored too
            # (index only the matched subset: with zero GT boxes pa is all
            # -1 and ignore_gt is empty, so a blanket gather would IndexError)
            matched_ignored = np.zeros(len(pa), bool)
            matched_ignored[correct] = ignore_gt[pa[correct]]
            ignore_pred |= matched_ignored
            for k in list(gt):
                gt[k] = U.masked_select(gt[k], ~ignore_gt)
            for k in list(pred):
                pred[k] = U.masked_select(pred[k], ~ignore_pred)

    n_gt = sum(len(g['bbox']) for g in gts)
    merged = _sort_by(_merge(preds), 'score') if preds else None

    res = {'ap_auc': 0.0, 'ap_interp': 0.0, 'recall_2d': 0.0,
           'precision_2d': 0.0}
    if val_field is not None:
        res[val_metric_name] = 0.0
    if calc_op:
        res.update({'recall_op': 0.0, 'precision_op': 0.0, 'score_op': 0.0})

    if return_curves:
        res['curves'] = {'recall': np.zeros(0, np.float32),
                         'precision': np.zeros(0, np.float32),
                         'score': np.zeros(0, np.float32)}
    if merged is None or len(merged['correct']) == 0:
        return res

    recs, precs = calc_recall_precision(merged['correct'], n_gt)
    if return_curves:
        res['curves'] = {'recall': recs.astype(np.float32),
                         'precision': precs.astype(np.float32),
                         'score': U.to_numpy(merged['score']).astype(np.float32)}
    res['recall_2d'] = float(recs[-1])
    res['precision_2d'] = float(precs[-1])
    res['ap_auc'] = calc_ap_auc(recs, precs)
    res['ap_interp'] = calc_ap_interp(recs, precs, n_inter)

    if val_field is not None:
        sims = U.to_numpy(sim_func(merged[val_field],
                                   merged['assigned_' + val_field]))
        c = merged['correct']
        res[val_metric_name] = float(np.mean(sims[c])) if np.any(c) else 0.0

    if calc_op:
        op = calc_optimal_op_index(recs, precs, U.to_numpy(merged['score']))
        if isinstance(op, tuple):
            res['recall_op'] = math.sqrt(recs[op[0]] * recs[op[1]])
            res['precision_op'] = math.sqrt(precs[op[0]] * precs[op[1]])
            res['score_op'] = math.sqrt(merged['score'][op[0]] * merged['score'][op[1]])
        elif op >= 0:
            res['recall_op'] = float(recs[op])
            res['precision_op'] = float(precs[op])
            res['score_op'] = float(merged['score'][op])
    return res


def cosine_similarity(a_deg, b_deg):
    """AOS yaw similarity, KITTI eqs. 4-5 (eval.py:726-740); inputs degrees."""
    a = U.to_numpy(a_deg).astype(np.float64)
    b = U.to_numpy(b_deg).astype(np.float64)
    diff = np.fmod(np.abs(a - b), 360.0)
    diff = U.where(diff > 180.0, 360.0 - diff, diff)
    return (1.0 + np.cos(np.radians(diff))) / 2.0


class MAPCalculator:
    """Accumulates per-frame GT/pred and computes the BEV metric suite
    (utils/eval.py:666-723)."""

    def __init__(self):
        self.preds: List = []
        self.gts: List = []
        self.img_names: List = []
        # class ids ignored after association (the reference's
        # unlabeled_classes, eval.py:672,711); config-like — reset() keeps it
        self.ignore_classes: List = []

    def __len__(self):
        return len(self.preds)

    def reset(self):
        self.preds, self.gts, self.img_names = [], [], []

    def update(self, gt, pred, img_names=None):
        """gt: list of [boxes [K,9], labels [K]]; pred: list of
        [boxes [K,9], scores [K], labels [K]] — the reference's
        result_list/target_list layout (mm_training_aim.py:315-321).

        Accepts numpy arrays or torch tensors: the universal array layer
        moves them to host numpy here, as the reference evaluator runs on
        either torch or numpy via utils/universal (eval.py:11)."""
        def host(frame):
            return [U.to_numpy(a)
                    if U.is_tensor_or_ndarray(a) else a
                    for a in frame]

        self.gts.extend(host(f) for f in gt)
        self.preds.extend(host(f) for f in pred)
        # reconcile names to the frame count: a padded eval batch hands the
        # full-length path list with a truncated (n_valid) frame list, and a
        # longer name list would desynchronize zip(self.gts, self.img_names)
        # for every later frame
        names = list(img_names) if img_names is not None else []
        names = names[:len(gt)] + [None] * max(0, len(gt) - len(names))
        self.img_names.extend(names)

    def compute_bev(self, eval_class=None, iou_thr=0.3,
                    assign_method='hunscore', x_range=200.0) -> Dict[str, float]:
        gts = [obj2arrays_bev(x[0], x[1], name=n, x_range=x_range)
               for x, n in zip(self.gts, self.img_names)]
        preds = [obj2arrays_bev(x[0], x[2], x[1], name=n, needs_score=True,
                                x_range=x_range)
                 for x, n in zip(self.preds, self.img_names)]
        num_preds = sum(len(p['bbox']) for p in preds)

        result = evaluate_ap(gts, preds, eval_class=eval_class, iou_th=iou_thr,
                             assign_method=assign_method, val_field='class',
                             sim_func=lambda a, b: a == b,
                             val_metric_name='cls_accuracy_bev',
                             unlabeled_classes=self.ignore_classes)
        result['num_preds'] = num_preds
        yaw = evaluate_ap(gts, preds, eval_class=eval_class, iou_th=iou_thr,
                          assign_method=assign_method, val_field='yaw',
                          sim_func=cosine_similarity, val_metric_name='aos',
                          unlabeled_classes=self.ignore_classes)
        result['aos'] = yaw['aos']
        return result

    def compute_bev_curves(self, iou_thr=0.3, assign_method='hunscore',
                           x_range=200.0, class_names=None) -> Dict[str, dict]:
        """Overall + per-class AP with full PR curves (the reference saves
        these plots per eval, utils/eval.py:483-499)."""
        gts = [obj2arrays_bev(x[0], x[1], name=n, x_range=x_range)
               for x, n in zip(self.gts, self.img_names)]
        preds = [obj2arrays_bev(x[0], x[2], x[1], name=n, needs_score=True,
                                x_range=x_range)
                 for x, n in zip(self.preds, self.img_names)]
        present = sorted({int(c) for g in gts for c in g['class']}
                         | {int(c) for p in preds for c in p['class']})
        out = {'all': evaluate_ap(gts, preds, iou_th=iou_thr,
                                  assign_method=assign_method,
                                  return_curves=True,
                                  unlabeled_classes=self.ignore_classes)}
        for c in present:
            name = (class_names[c] if class_names and c < len(class_names)
                    else str(c))
            out[name] = evaluate_ap(gts, preds, eval_class=c, iou_th=iou_thr,
                                    assign_method=assign_method,
                                    return_curves=True,
                                    unlabeled_classes=self.ignore_classes)
        return out

    def export_pr_curves(self, out_dir, iou_thr=0.3,
                         assign_method='hunscore', x_range=200.0,
                         class_names=None) -> List[str]:
        """Write PR curves (overall + per class) under out_dir: a JSON with
        the curve points + AP numbers, and a PNG plot per curve when
        matplotlib is available (parity with eval.py:483-499 plot saving).
        Returns the written file paths."""
        import json
        import os
        os.makedirs(out_dir, exist_ok=True)
        curves = self.compute_bev_curves(iou_thr=iou_thr,
                                         assign_method=assign_method,
                                         x_range=x_range,
                                         class_names=class_names)
        written = []
        payload = {}
        for name, res in curves.items():
            c = res.pop('curves')
            payload[name] = {
                'ap_auc': res['ap_auc'], 'ap_interp': res['ap_interp'],
                'recall': c['recall'].tolist(),
                'precision': c['precision'].tolist(),
                'score': c['score'].tolist(),
            }
        json_path = os.path.join(out_dir, 'pr_curves.json')
        with open(json_path, 'w') as f:
            json.dump(payload, f)
        written.append(json_path)
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
        except ImportError:  # pragma: no cover
            return written
        for name, d in payload.items():
            name = name.replace('/', '-').replace(' ', '_')  # 'truck/bus'
            fig, ax = plt.subplots(figsize=(5, 4))
            ax.plot(d['recall'], d['precision'])
            ax.set_xlabel('recall')
            ax.set_ylabel('precision')
            ax.set_xlim(0, 1)
            ax.set_ylim(0, 1.05)
            ax.set_title(f'{name}: AP(auc)={d["ap_auc"]:.3f}')
            png = os.path.join(out_dir, f'pr_curve_{name}.png')
            fig.savefig(png, dpi=100, bbox_inches='tight')
            plt.close(fig)
            written.append(png)
        return written
