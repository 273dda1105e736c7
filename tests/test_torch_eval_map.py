"""The port's BEV mAP evaluator (``evaluation/bev_map.py``) against the JAX
package's, and the port's counterparts of the fast cases of
``tests/test_eval/test_bev_map.py``, ``test_pr_curves.py`` and
``test_export_roundtrip.py``.

Both evaluators compute in numpy with the same arithmetic, so every metric,
curve and exported file is held equal (tolerance 0)."""
import json
import os

import numpy as np
import pytest
import torch

from mm_training_tpu.evaluation import MAPCalculator as JMAPCalculator
from mm_training_tpu_torch.configs import CLASSES
from mm_training_tpu_torch.data.formats import object_to_array
from mm_training_tpu_torch.evaluation import MAPCalculator
from mm_training_tpu_torch.evaluation.bev_map import (assign_hunscore, assign_scoresort,
                                                      box_iou_aabb, cosine_similarity,
                                                      evaluate_ap, obj2arrays_bev)
from mm_training_tpu_torch.training.trainer import boxes_to_aimotive_dict


def _box(x, y, dx=4.0, dy=2.0, z=0.0, dz=1.5, yaw=0.0, vx=0.0, vy=0.0):
    return [x, y, z, dx, dy, dz, yaw, vx, vy]


def _random_frames(seed=0, n_frames=6):
    """Ground truth and predictions of a detector that finds most boxes:
    each GT box jittered by up to ~1 m (some beyond the IoU thresholds),
    some dropped, false positives added, labels sometimes wrong, yaw
    noisy, a few boxes beyond x = 200 m, and one frame with no GT."""
    rng = np.random.default_rng(seed)
    gts, preds = [], []
    for f in range(n_frames):
        k = 0 if f == 2 else int(rng.integers(3, 12))
        boxes = np.zeros((k, 9), np.float32)
        boxes[:, 0] = rng.uniform(-220, 220, k)
        boxes[:, 1] = rng.uniform(-20, 20, k)
        boxes[:, 3:6] = rng.uniform(0.6, 8.0, (k, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, k)
        labels = rng.integers(0, 5, k)
        keep = rng.uniform(size=k) < 0.8
        pb = boxes[keep].copy()
        pb[:, :2] += rng.normal(0, 0.6, (len(pb), 2))
        pb[:, 6] += rng.normal(0, 0.3, len(pb))
        pl = np.where(rng.uniform(size=len(pb)) < 0.8, labels[keep], rng.integers(0, 5, len(pb)))
        nfp = int(rng.integers(0, 4))
        fp = np.zeros((nfp, 9), np.float32)
        fp[:, 0] = rng.uniform(-200, 200, nfp)
        fp[:, 1] = rng.uniform(-20, 20, nfp)
        fp[:, 3:6] = [4.0, 2.0, 1.5]
        scores = rng.uniform(0.05, 1.0, len(pb) + nfp).astype(np.float32)
        gts.append([boxes, labels])
        preds.append([np.concatenate([pb, fp]), scores,
                      np.concatenate([pl, rng.integers(0, 5, nfp)])])
    return gts, preds


def _both(gts, preds, ignore=()):
    j, t = JMAPCalculator(), MAPCalculator()
    for calc in (j, t):
        calc.ignore_classes = list(ignore)
        calc.update(gts, preds, [f'f{i}' for i in range(len(gts))])
    return j, t


@pytest.mark.parametrize('iou_thr', [0.3, 0.5])
@pytest.mark.parametrize('assign', ['hunscore', 'scoresort', 'huniou', 'distance'])
@pytest.mark.parametrize('ignore', [(), (4,)])
def test_metrics_equal_jax(assign, iou_thr, ignore):
    """Every metric of ``compute_bev`` (overall and per class) equal to the
    JAX package's, for the four matchers at two thresholds (the distance
    matcher's threshold in metres: 1.5 and 2.5) and with ignored classes."""
    gts, preds = _random_frames()
    j, t = _both(gts, preds, ignore)
    thr = iou_thr + 1.2 if assign == 'distance' else iou_thr
    for eval_class in (None, 0, 1):
        want = j.compute_bev(eval_class=eval_class, iou_thr=thr, assign_method=assign,
                             x_range=204.8)
        got = t.compute_bev(eval_class=eval_class, iou_thr=thr, assign_method=assign,
                            x_range=204.8)
        assert got == want
        if eval_class is None:       # the comparison has substance
            assert 0 < want['ap_auc'] < 1 and 0 < want['aos'] < 1, want


def test_curves_and_exported_files_equal_jax(tmp_path):
    """The PR curves (overall and per class) and every exported file (the
    JSON, and the PNG plots when matplotlib is installed) byte for byte."""
    gts, preds = _random_frames(seed=1)
    j, t = _both(gts, preds)
    want = j.compute_bev_curves(x_range=204.8, class_names=list(CLASSES))
    got = t.compute_bev_curves(x_range=204.8, class_names=list(CLASSES))
    assert list(got) == list(want)
    for name in want:
        for k in want[name]:
            if k == 'curves':
                for c in want[name][k]:
                    np.testing.assert_array_equal(got[name][k][c], want[name][k][c])
            else:
                assert got[name][k] == want[name][k], (name, k)
    jw = j.export_pr_curves(str(tmp_path / 'j'), x_range=204.8, class_names=list(CLASSES))
    tw = t.export_pr_curves(str(tmp_path / 't'), x_range=204.8, class_names=list(CLASSES))
    assert [os.path.basename(p) for p in tw] == [os.path.basename(p) for p in jw]
    for a, b in zip(jw, tw):
        with open(a, 'rb') as fa, open(b, 'rb') as fb:
            assert fa.read() == fb.read(), b


# ------------------------------------------------ test_bev_map.py counterparts

def _calc(gt_boxes, gt_labels, pred_boxes, scores, pred_labels, ignore=()):
    calc = MAPCalculator()
    calc.ignore_classes = list(ignore)
    calc.update([[np.asarray(gt_boxes, np.float32), np.asarray(gt_labels)]],
                [[np.asarray(pred_boxes, np.float32), np.asarray(scores, np.float32),
                  np.asarray(pred_labels)]])
    return calc


def _perfect():
    boxes = [_box(10, 2), _box(-30, -5), _box(100, 10)]
    return _calc(boxes, [0, 1, 3], boxes, [0.9, 0.8, 0.7], [0, 1, 3]), {}, {
        'ap_auc': 1.0, 'recall_2d': 1.0, 'precision_2d': 1.0, 'cls_accuracy_bev': 1.0,
        'aos': 1.0, 'num_preds': 3}


def _false_positive():
    return _calc([_box(10, 2)], [0], [_box(10, 2), _box(50, 5)], [0.9, 0.8], [0, 0]), {}, {
        'recall_2d': 1.0, 'precision_2d': 0.5, 'ap_auc': 1.0}


def _x_range():
    return _calc([_box(10, 2), _box(300, 2)], [0, 0], [_box(10, 2)], [0.9], [0]), {}, {
        'recall_2d': 1.0}


def _wrong_class():
    return _calc([_box(10, 2)], [0], [_box(10, 2)], [0.9], [2]), {}, {
        'recall_2d': 1.0, 'cls_accuracy_bev': 0.0}


def _distance_near():
    boxes = [_box(10, 2), _box(-30, -5)]
    return _calc(boxes, [0, 1], boxes, [0.9, 0.8], [0, 1]), dict(
        assign_method='distance', iou_thr=2.0), {'ap_auc': 1.0}


def _distance_far():
    boxes = np.asarray([_box(10, 2), _box(-30, -5)], np.float32)
    off = boxes.copy()
    off[:, 0] += 30.0  # 30 m away: must NOT match at a 2 m threshold
    return _calc(boxes, [0, 1], off, [0.9, 0.8], [0, 1]), dict(
        assign_method='distance', iou_thr=2.0), {'ap_auc': 0.0}


def _ignore_classes():
    # a correct class-0 pred, a pred matched to the ignored GT, and a
    # class-7 false positive — only the first counts
    return _calc([_box(10, 2), _box(50, 5)], [0, 7],
                 [_box(10, 2), _box(50, 5), _box(90, -5)], [0.9, 0.8, 0.7], [0, 7, 7],
                 ignore=[7]), {}, {'ap_auc': 1.0, 'recall_2d': 1.0, 'precision_2d': 1.0}


def _ignore_classes_empty_gt_frame():
    calc = MAPCalculator()
    calc.ignore_classes = [7]
    gt = np.asarray([_box(20, -3)], np.float32)
    calc.update([[np.zeros((0, 7), np.float32), np.zeros((0,), np.int64)],
                 [gt, np.asarray([0])]],
                [[np.asarray([_box(10, 2), _box(50, 5)], np.float32),
                  np.asarray([0.9, 0.8], np.float32), np.asarray([0, 7])],
                 [gt, np.asarray([0.95], np.float32), np.asarray([0])]])
    return calc, {}, {'recall_2d': 1.0, 'precision_2d': 0.5}


SCENARIOS = {'perfect': _perfect, 'false_positive': _false_positive, 'x_range': _x_range,
             'wrong_class': _wrong_class, 'distance_near': _distance_near,
             'distance_far': _distance_far, 'ignore_classes': _ignore_classes,
             'ignore_classes_empty_gt_frame': _ignore_classes_empty_gt_frame}


@pytest.mark.parametrize('name', list(SCENARIOS))
def test_scenarios(name):
    """The fast MAPCalculator cases of ``tests/test_eval/test_bev_map.py``
    on the port, each also equal to the JAX evaluator on the same boxes."""
    calc, kw, expected = SCENARIOS[name]()
    kw = dict(dict(iou_thr=0.3, x_range=204.8), **kw)
    res = calc.compute_bev(**kw)
    for k, v in expected.items():
        assert res[k] == pytest.approx(v, abs=1e-6), k
    jcalc = JMAPCalculator()
    jcalc.ignore_classes = calc.ignore_classes
    jcalc.update(calc.gts, calc.preds, calc.img_names)
    assert res == jcalc.compute_bev(**kw)


def _case_box_iou():
    a = np.asarray([[0, 0, 2, 2]], np.float32)
    b = np.asarray([[1, 1, 3, 3], [0, 0, 2, 2], [5, 5, 6, 6]], np.float32)
    np.testing.assert_allclose(box_iou_aabb(a, b)[0], [1 / 7, 1.0, 0.0], atol=1e-6)


def _case_aos():
    assert cosine_similarity(np.asarray([0.0]), np.asarray([0.0]))[0] == 1.0
    assert cosine_similarity(np.asarray([0.0]), np.asarray([180.0]))[0] == pytest.approx(0.0)
    assert cosine_similarity(np.asarray([0.0]), np.asarray([90.0]))[0] == pytest.approx(0.5)
    assert cosine_similarity(np.asarray([350.0]), np.asarray([-10.0]))[0] == pytest.approx(1.0)


def _case_matchers_agree():
    ious = np.asarray([[0.9, 0.0], [0.0, 0.8]], np.float32)
    scores = np.asarray([0.9, 0.8], np.float32)
    for assign in (assign_scoresort, assign_hunscore):
        gt_a, _ = assign(ious, scores, 0.3)
        assert gt_a == {0: [0], 1: [1]}


def _case_hungarian_contention():
    # one GT, two overlapping preds: Hungarian-on-score keeps the higher score
    _, pred_a = assign_hunscore(np.asarray([[0.9, 0.85]], np.float32),
                                np.asarray([0.2, 0.95], np.float32), 0.3)
    assert list(pred_a.keys()) == [1]


def _case_evaluate_ap_accepts_tensors():
    """Tensors (any device) through the array layer give numpy's metrics
    (the JAX test feeds jax arrays)."""
    rng = np.random.default_rng(0)
    boxes = rng.uniform(-50, 50, (6, 9)).astype(np.float32)
    boxes[:, 3:6] = rng.uniform(2, 5, (6, 3))
    classes = rng.integers(0, 3, 6)
    scores = rng.uniform(0.1, 1.0, 6).astype(np.float32)
    gt = obj2arrays_bev(boxes[:4], classes[:4], name='f0')
    pr = obj2arrays_bev(boxes, classes, scores, name='f0', needs_score=True)
    kw = dict(val_field='class', sim_func=lambda a, b: a == b,
              val_metric_name='cls_accuracy_bev')
    ref = evaluate_ap([gt], [pr], **kw)
    tgt = obj2arrays_bev(torch.from_numpy(boxes[:4]), torch.from_numpy(classes[:4]), name='f0')
    tpr = obj2arrays_bev(torch.from_numpy(boxes), torch.from_numpy(classes),
                         torch.from_numpy(scores), name='f0', needs_score=True)
    assert evaluate_ap([tgt], [tpr], **kw) == ref


def _case_names_follow_frames():
    """A padded eval batch passes the full-length path list with a truncated
    (n_valid) frame list; names must stay frame-aligned."""
    boxes, labels = np.asarray([_box(10, 2)], np.float32), np.asarray([0])
    scores = np.asarray([0.9], np.float32)
    calc = MAPCalculator()
    calc.update([[boxes, labels]], [[boxes, scores, labels]], img_names=['a', 'b'])
    calc.update([[boxes, labels]], [[boxes, scores, labels]], img_names=['c'])
    assert calc.img_names == ['a', 'c'] and len(calc.img_names) == len(calc.gts)


def _pr_frames():
    rng = np.random.default_rng(0)
    gts, preds = [], []
    for _ in range(4):
        k = 6
        boxes = np.zeros((k, 9), np.float32)
        boxes[:, 0] = rng.uniform(-40, 40, k)
        boxes[:, 1] = rng.uniform(-10, 10, k)
        boxes[:, 3:6] = [4.0, 2.0, 1.5]
        labels = rng.integers(0, 2, k)
        gts.append([boxes, labels])
        pb = boxes.copy()
        pb[:, :2] += rng.normal(0, 0.2, (k, 2))
        fp = np.zeros((1, 9), np.float32)
        fp[:, :2] = [100.0, 0.0]
        fp[:, 3:6] = [4.0, 2.0, 1.5]
        preds.append([np.concatenate([pb, fp]),
                      np.concatenate([rng.uniform(0.5, 1.0, k), [0.4]]),
                      np.concatenate([labels, [0]])])
    return gts, preds


def _case_curves_consistent_with_compute_bev():
    calc = MAPCalculator()
    calc.update(*_pr_frames())
    bev = calc.compute_bev(x_range=200.0)
    assert abs(calc.compute_bev_curves(x_range=200.0)['all']['ap_auc'] - bev['ap_auc']) < 1e-9


def _case_update_accepts_tensors():
    gts, preds = _pr_frames()
    calc = MAPCalculator()
    calc.update([[torch.from_numpy(b), torch.from_numpy(lb)] for b, lb in gts],
                [[torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(lb)]
                 for b, s, lb in preds])
    assert isinstance(calc.gts[0][0], np.ndarray)
    ref = MAPCalculator()
    ref.update(gts, preds)
    assert calc.compute_bev(x_range=200.0) == ref.compute_bev(x_range=200.0)


CASES = {'box_iou_aabb': _case_box_iou, 'aos_yaw_similarity': _case_aos,
         'matchers_agree': _case_matchers_agree,
         'hungarian_contention': _case_hungarian_contention,
         'evaluate_ap_accepts_tensors': _case_evaluate_ap_accepts_tensors,
         'img_names_follow_frames': _case_names_follow_frames,
         'curves_consistent_with_compute_bev': _case_curves_consistent_with_compute_bev,
         'update_accepts_tensors': _case_update_accepts_tensors}


@pytest.mark.parametrize('name', list(CASES))
def test_evaluator_cases(name):
    """The remaining fast cases of ``test_bev_map.py`` and
    ``test_pr_curves.py`` on the port (torch tensors where the JAX tests
    feed jax arrays)."""
    CASES[name]()


def test_export_pr_curves(tmp_path):
    """test_pr_curves.py::test_export_pr_curves on the port."""
    calc = MAPCalculator()
    calc.update(*_pr_frames())
    written = calc.export_pr_curves(str(tmp_path), x_range=200.0, class_names=['car', 'truck'])
    jpath = os.path.join(str(tmp_path), 'pr_curves.json')
    assert jpath in written and os.path.getsize(jpath) > 0
    with open(jpath) as f:
        payload = json.load(f)
    assert 'all' in payload and 'car' in payload
    for d in payload.values():
        assert len(d['recall']) == len(d['precision']) == len(d['score'])
        assert 0.0 <= d['ap_auc'] <= 1.0
    assert payload['all']['ap_auc'] > 0.8
    assert len(payload['all']['recall']) == 28  # 4 frames x 7 preds


def test_export_parses_back_to_same_boxes(tmp_path):
    """test_export_roundtrip.py on the port: the trainer's aiMotive-JSON
    export parses back through the dataset's reader into the same boxes
    (bottom z -> origin z, the quaternion yaw round trip), and equals the
    JAX exporter's dict."""
    from mm_training_tpu.training.trainer import boxes_to_aimotive_dict as j_export
    rng = np.random.default_rng(0)
    n = 5
    boxes = np.zeros((n, 9), np.float32)
    boxes[:, 0] = rng.uniform(-100, 100, n)
    boxes[:, 1] = rng.uniform(-20, 20, n)
    boxes[:, 2] = rng.uniform(-2, 0, n)            # bottom z (decode output)
    boxes[:, 3:6] = rng.uniform(0.5, 8, (n, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    boxes[:, 7:9] = rng.normal(0, 5, (n, 2))
    scores = rng.uniform(0.1, 1, n).astype(np.float32)
    labels = rng.integers(0, 4, n)

    d = boxes_to_aimotive_dict(boxes, scores, labels)
    assert d == j_export(boxes, scores, labels)
    path = tmp_path / 'frame_0000001.json'
    path.write_text(json.dumps(d))
    objs = json.loads(path.read_text())['CapturedObjects']
    assert len(objs) == n
    for i, o in enumerate(objs):
        arr, tname = object_to_array(o)
        arr = np.asarray(arr)
        np.testing.assert_allclose(arr[0:2], boxes[i, 0:2], atol=1e-5)
        np.testing.assert_allclose(arr[2], boxes[i, 2] + boxes[i, 5] / 2, atol=1e-5)
        np.testing.assert_allclose(arr[3:6], boxes[i, 3:6], atol=1e-5)
        dyaw = (arr[6] - boxes[i, 6] + np.pi) % (2 * np.pi) - np.pi
        assert abs(dyaw) < 1e-5
        np.testing.assert_allclose(arr[7:9], boxes[i, 7:9], atol=1e-5)
        assert tname == CLASSES[labels[i]]
        assert 0 <= o['Score'] <= 1
