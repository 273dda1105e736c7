"""The nuScenes detection protocol, without the devkit: mAP, the five TP
errors and NDS.

The port of ``mm_training_tpu/evaluation/nuscenes_eval.py``, numpy as
there (the reference, evaluators/det_mv_evaluators.py:15-299, formats its
results and calls the nuscenes-devkit; this is the protocol itself):

  * per class and centre-distance threshold d in {0.5, 1, 2, 4} m: greedy
    score-ordered matching of predictions to unmatched ground truth within
    d; AP is the mean precision over recall in (0.1, 1] (the 101-point
    curve, the nuScenes "clipped" AP).
  * TP errors at d = 2 m over the true positives: ATE (centre distance, m),
    ASE (1 - IoU of the aligned boxes), AOE (yaw difference, rad; period pi
    for barriers), AVE (velocity L2), AAE (attributes: the reference
    predicts none and assigns each class its default, so 0). The devkit's
    exclusions apply: cones carry no AOE/AVE/AAE and barriers no AVE/AAE
    (NaN, left out of the means), and a class whose largest recall is at
    most 0.1 gets the worst-case 1.0 for every error.
  * NDS = (5 * mAP + sum over the TP errors of (1 - min(1, err))) / 10.

Also the submission JSON the reference writes (:func:`format_results`).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ['NuScenesEvaluator', 'nusc_accumulate', 'format_results']

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_RECALL_PTS = 101

DEFAULT_CLASSES = ('car', 'truck', 'construction_vehicle', 'bus', 'trailer',
                   'barrier', 'motorcycle', 'bicycle', 'pedestrian',
                   'traffic_cone')
# classes whose AOE uses period pi (nuScenes: barrier); velocities/attrs are
# skipped for cones+barriers per the official config
PERIOD_PI_CLASSES = ('barrier',)
NO_VEL_CLASSES = ('barrier', 'traffic_cone')

DEFAULT_ATTRIBUTES = {
    'car': 'vehicle.parked', 'pedestrian': 'pedestrian.moving',
    'trailer': 'vehicle.parked', 'truck': 'vehicle.parked',
    'bus': 'vehicle.moving', 'motorcycle': 'cycle.without_rider',
    'construction_vehicle': 'vehicle.parked', 'bicycle': 'cycle.without_rider',
    'barrier': '', 'traffic_cone': '',
}


def _aligned_iou_3d(gt: np.ndarray, pred: np.ndarray) -> float:
    """IoU of two boxes translated to a common center, yaw-aligned — the
    nuScenes scale-error definition (1 - this)."""
    inter = np.prod(np.minimum(gt[3:6], pred[3:6]))
    union = np.prod(gt[3:6]) + np.prod(pred[3:6]) - inter
    return float(inter / max(union, 1e-9))


def _yaw_diff(a: float, b: float, period: float = 2 * np.pi) -> float:
    d = (a - b) % period
    return float(min(d, period - d))


def nusc_accumulate(gts: List[Dict[str, np.ndarray]],
                    preds: List[Dict[str, np.ndarray]],
                    class_name: str, dist_th: float) -> Dict[str, np.ndarray]:
    """One (class, threshold) accumulation over all frames.

    Each frame dict: boxes [K, 9] (x,y,z,dx,dy,dz,yaw,vx,vy), names [K] str
    array, and for predictions scores [K].
    Returns per-prediction tp/fp flags sorted by score plus the matched TP
    error vectors.
    """
    n_gt = 0
    rows = []  # (score, tp, ate, ase, aoe, ave)
    period = np.pi if class_name in PERIOD_PI_CLASSES else 2 * np.pi
    for gt, pred in zip(gts, preds):
        g_sel = gt['names'] == class_name
        g_boxes = gt['boxes'][g_sel]
        n_gt += int(g_sel.sum())
        p_sel = pred['names'] == class_name
        p_boxes = pred['boxes'][p_sel]
        p_scores = pred['scores'][p_sel]
        order = np.argsort(-p_scores)
        taken = np.zeros(len(g_boxes), bool)
        for pi in order:
            pb = p_boxes[pi]
            if len(g_boxes):
                d = np.hypot(g_boxes[:, 0] - pb[0], g_boxes[:, 1] - pb[1])
                d = np.where(taken, np.inf, d)
                j = int(np.argmin(d))
                best = d[j]
            else:
                best = np.inf
            if best < dist_th:
                taken[j] = True
                gb = g_boxes[j]
                ate = best
                ase = 1.0 - _aligned_iou_3d(gb, pb)
                aoe = _yaw_diff(gb[6], pb[6], period)
                ave = (float(np.hypot(gb[7] - pb[7], gb[8] - pb[8]))
                       if class_name not in NO_VEL_CLASSES else 0.0)
                rows.append((p_scores[pi], 1, ate, ase, aoe, ave))
            else:
                rows.append((p_scores[pi], 0, 0, 0, 0, 0))
    if not rows:
        return {'n_gt': n_gt, 'tp': np.zeros((0,)), 'scores': np.zeros((0,)),
                'errs': np.zeros((0, 4))}
    rows.sort(key=lambda r: -r[0])
    arr = np.asarray(rows, np.float64)
    return {'n_gt': n_gt, 'scores': arr[:, 0], 'tp': arr[:, 1],
            'errs': arr[:, 2:6]}


def _clipped_ap(acc: Dict) -> float:
    """nuScenes AP: 101-pt precision over recall, clipped below
    (MIN_RECALL, MIN_PRECISION), normalized by the remaining area."""
    n_gt = acc['n_gt']
    if n_gt == 0 or len(acc['tp']) == 0:
        return 0.0
    tp = np.cumsum(acc['tp'])
    fp = np.cumsum(1 - acc['tp'])
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1e-9)
    r_pts = np.linspace(0, 1, N_RECALL_PTS)
    p_interp = np.interp(r_pts, recall, precision, right=0)
    # devkit calc_ap drops bins 0..round(100*min_recall) INCLUSIVE
    # (prec[round(100*min_recall)+1:], 90 bins) — the r=0.1 bin is excluded
    p_interp = p_interp[round(100 * MIN_RECALL) + 1:]
    p_clip = np.maximum(p_interp - MIN_PRECISION, 0)
    return float(p_clip.sum() / (len(p_clip) * (1 - MIN_PRECISION)))


def _tp_error_means(acc: Dict) -> Dict[str, float]:
    """devkit calc_tp: cumulative-mean TP-error curves sampled on the 101-pt
    recall grid and averaged over bins (MIN_RECALL, max_recall]; a class whose
    max recall never exceeds MIN_RECALL gets the worst-case 1.0 for every
    error (nuscenes-devkit detection/algo.py calc_tp)."""
    worst = {'ate': 1.0, 'ase': 1.0, 'aoe': 1.0, 'ave': 1.0}
    n_gt = acc['n_gt']
    sel = acc['tp'] > 0
    if n_gt == 0 or not np.any(sel):
        return worst
    recall_curve = np.cumsum(acc['tp']) / n_gt             # per prediction
    first_ind = round(100 * MIN_RECALL) + 1                # bin 11
    max_recall_ind = int(np.floor(100 * recall_curve[-1] + 1e-9))
    if max_recall_ind < first_ind:
        return worst
    r_pts = np.linspace(0, 1, N_RECALL_PTS)[first_ind:max_recall_ind + 1]
    errs = acc['errs'][sel]
    cummean = np.cumsum(errs, axis=0) / np.arange(1, len(errs) + 1)[:, None]
    recall_at_tp = recall_curve[sel]
    return {k: float(np.mean(np.interp(r_pts, recall_at_tp, cummean[:, i])))
            for i, k in enumerate(('ate', 'ase', 'aoe', 'ave'))}


class NuScenesEvaluator:
    """Accumulate frames, compute {mAP, mATE, mASE, mAOE, mAVE, mAAE, NDS}.

    update(gt_boxes, gt_names, pred_boxes, pred_scores, pred_names) per frame
    with 9-dim boxes; compute() returns the metric dict.
    """

    def __init__(self, classes: Sequence[str] = DEFAULT_CLASSES):
        self.classes = tuple(classes)
        self.reset()

    def reset(self):
        self._gts: List[Dict] = []
        self._preds: List[Dict] = []

    def update(self, gt_boxes, gt_names, pred_boxes, pred_scores, pred_names):
        self._gts.append({'boxes': np.asarray(gt_boxes, np.float64).reshape(-1, 9),
                          'names': np.asarray(gt_names, object)})
        self._preds.append({'boxes': np.asarray(pred_boxes, np.float64).reshape(-1, 9),
                            'scores': np.asarray(pred_scores, np.float64),
                            'names': np.asarray(pred_names, object)})

    def compute(self) -> Dict[str, float]:
        aps, errs = [], []
        per_class = {}
        for cls in self.classes:
            cls_aps = []
            for th in DIST_THRESHOLDS:
                acc = nusc_accumulate(self._gts, self._preds, cls, th)
                cls_aps.append(_clipped_ap(acc))
            acc_tp = nusc_accumulate(self._gts, self._preds, cls, TP_THRESHOLD)
            e = _tp_error_means(acc_tp)
            e['aae'] = 0.0  # default-attribute assignment => no attr error
            # devkit class exclusions (evaluate.py): cones have no
            # orientation/velocity/attribute, barriers no velocity/attribute;
            # those entries are NaN and nanmean-excluded from the fleet means
            if cls in NO_VEL_CLASSES:
                e['ave'] = float('nan')
                e['aae'] = float('nan')
            if cls == 'traffic_cone':
                e['aoe'] = float('nan')
            per_class[cls] = {'ap': float(np.mean(cls_aps)), **e}
            if acc_tp['n_gt'] > 0:
                aps.append(per_class[cls]['ap'])
                errs.append(e)
        if not aps:
            return {'mAP': 0.0, 'mATE': 1.0, 'mASE': 1.0, 'mAOE': 1.0,
                    'mAVE': 1.0, 'mAAE': 1.0, 'NDS': 0.0}

        def _nanmean(vals) -> float:
            a = np.asarray(vals, np.float64)
            if np.all(np.isnan(a)):  # only excluded classes present
                return 1.0
            return float(np.nanmean(a))

        m = {
            'mAP': float(np.mean(aps)),
            'mATE': _nanmean([e['ate'] for e in errs]),
            'mASE': _nanmean([e['ase'] for e in errs]),
            'mAOE': _nanmean([e['aoe'] for e in errs]),
            'mAVE': _nanmean([e['ave'] for e in errs]),
            'mAAE': _nanmean([e['aae'] for e in errs]),
        }
        tp_score = sum(1.0 - min(1.0, m[k]) for k in
                       ('mATE', 'mASE', 'mAOE', 'mAVE', 'mAAE'))
        m['NDS'] = float((5 * m['mAP'] + tp_score) / 10.0)
        m['per_class'] = per_class
        return m


def format_results(tokens: List[str], boxes_list, scores_list, names_list,
                   out_path: Optional[str] = None) -> Dict:
    """nuScenes submission JSON (DetMVNuscEvaluator._format_bbox parity):
    results[sample_token] = [{translation, size, rotation, velocity,
    detection_name, detection_score, attribute_name}]."""
    results = {}
    for token, boxes, scores, names in zip(tokens, boxes_list, scores_list,
                                           names_list):
        anns = []
        for box, score, name in zip(np.asarray(boxes), np.asarray(scores),
                                    names):
            yaw = float(box[6])
            anns.append({
                'sample_token': token,
                'translation': [float(v) for v in box[:3]],
                'size': [float(box[4]), float(box[3]), float(box[5])],  # wlh
                'rotation': [float(np.cos(yaw / 2)), 0.0, 0.0,
                             float(np.sin(yaw / 2))],
                'velocity': [float(box[7]), float(box[8])],
                'detection_name': str(name),
                'detection_score': float(score),
                'attribute_name': DEFAULT_ATTRIBUTES.get(str(name), ''),
            })
        results[token] = anns
    sub = {'meta': {'use_camera': True, 'use_lidar': True, 'use_radar': False,
                    'use_map': False, 'use_external': False},
           'results': results}
    if out_path:
        os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
        with open(out_path, 'w') as f:
            json.dump(sub, f)
    return sub
