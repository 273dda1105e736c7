"""The port's nuScenes evaluator on the cases of
``tests/test_eval/test_nuscenes_eval.py``, each also held equal to the JAX
package's evaluator on the same frames; and both evaluators' whole
``compute()`` dicts equal (NaN where NaN) on seeded random frames of all
ten classes."""
import math

import numpy as np
import pytest

from mm_training_tpu.evaluation.nuscenes_eval import NuScenesEvaluator as JEvaluator
from mm_training_tpu.evaluation.nuscenes_eval import format_results as j_format_results
from mm_training_tpu_torch.evaluation import NuScenesEvaluator, format_results
from mm_training_tpu_torch.evaluation.nuscenes_eval import DEFAULT_CLASSES


def _frame(n, cls='car', jitter=0.0, seed=0):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((n, 9), np.float64)
    boxes[:, 0] = rng.uniform(-40, 40, n)
    boxes[:, 1] = rng.uniform(-40, 40, n)
    boxes[:, 3:6] = [4.5, 1.9, 1.6]
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    boxes[:, 7:9] = rng.normal(0, 3, (n, 2))
    pred = boxes.copy()
    pred[:, :2] += rng.normal(0, jitter, (n, 2))
    return boxes, pred, np.asarray([cls] * n, object)


def assert_same_metrics(got, want):
    """Equal dicts, nested, NaN where NaN."""
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same_metrics(got[k], want[k])
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want


def _compute(classes, frames):
    """Both evaluators over ``frames`` (update's arguments each); the port's
    metrics, held equal to the JAX package's."""
    ev, jev = NuScenesEvaluator(classes=classes), JEvaluator(classes=classes)
    for f in frames:
        ev.update(*f)
        jev.update(*f)
    m = ev.compute()
    assert_same_metrics(m, jev.compute())
    return m


def test_perfect_predictions():
    gt, pred, names = _frame(8)
    m = _compute(('car',), [(gt, names, pred, np.linspace(0.9, 0.5, 8), names)])
    assert m['mAP'] == pytest.approx(1.0, abs=1e-6)
    for k in ('mATE', 'mASE', 'mAOE'):
        assert m[k] == pytest.approx(0.0, abs=1e-9)
    assert m['NDS'] == pytest.approx(1.0, abs=1e-6)


def test_translation_error_reported():
    gt, pred, names = _frame(50, jitter=0.3, seed=1)
    m = _compute(('car',), [(gt, names, pred, np.full(50, 0.9), names)])
    assert 0.2 < m['mATE'] < 0.55      # 0.3 * sqrt(pi / 2) ~ 0.376
    assert m['mAP'] > 0.5


def test_misses_lower_map():
    gt, pred, names = _frame(10)
    m = _compute(('car',), [(gt, names, pred[:5], np.full(5, 0.9), names[:5])])
    assert 0.2 < m['mAP'] < 0.6


def test_class_confusion_not_matched():
    gt, pred, _ = _frame(6)
    m = _compute(('car', 'truck'), [(gt, np.asarray(['car'] * 6, object), pred, np.full(6, 0.9),
                                     np.asarray(['truck'] * 6, object))])
    assert m['per_class']['car']['ap'] == 0.0


def test_format_results_schema(tmp_path):
    gt, pred, names = _frame(2)
    sub = format_results(['tok1'], [pred], [np.asarray([0.9, 0.8])], [names],
                         out_path=str(tmp_path / 'sub.json'))
    want = j_format_results(['tok1'], [pred], [np.asarray([0.9, 0.8])], [names],
                            out_path=str(tmp_path / 'jax.json'))
    assert sub == want
    assert (tmp_path / 'sub.json').read_bytes() == (tmp_path / 'jax.json').read_bytes()
    ann = sub['results']['tok1'][0]
    assert set(ann) >= {'translation', 'size', 'rotation', 'velocity', 'detection_name',
                        'detection_score', 'attribute_name'}
    assert ann['size'] == [pred[0, 4], pred[0, 3], pred[0, 5]]      # wlh


def test_cone_barrier_tp_exclusions():
    """Cones carry no AOE/AVE/AAE: NaN, left out of the means."""
    gt_c, pred_c, names_c = _frame(6, cls='car', seed=2)
    gt_t, pred_t, names_t = _frame(6, cls='traffic_cone', seed=3)
    pred_c[:, 7] += 1.0
    names = np.concatenate([names_c, names_t])
    m = _compute(('car', 'traffic_cone'), [(np.concatenate([gt_c, gt_t]), names,
                                            np.concatenate([pred_c, pred_t]), np.full(12, 0.9),
                                            names)])
    pc = m['per_class']['traffic_cone']
    assert np.isnan(pc['aoe']) and np.isnan(pc['ave']) and np.isnan(pc['aae'])
    assert m['mAVE'] == pytest.approx(1.0, abs=1e-6)


def test_low_recall_gets_worst_case_tp_errors():
    gt, pred, names = _frame(20, seed=4)
    m = _compute(('car',), [(gt, names, pred[:1], np.asarray([0.9]), names[:1])])
    assert m['mATE'] == m['mASE'] == m['mAOE'] == m['mAVE'] == 1.0


def test_clipped_ap_excludes_min_recall_bin():
    """10 ground truths, 5 perfect predictions: 40 of the 90 bins above
    recall 0.1."""
    gt, pred, names = _frame(10, seed=5)
    m = _compute(('car',), [(gt, names, pred[:5], np.full(5, 0.9), names[:5])])
    assert m['mAP'] == pytest.approx(40 / 90, abs=1e-6)


def test_random_frames_of_all_ten_classes_match_jax():
    """12 seeded frames: ground truths of all ten classes, predictions
    jittered in place, size, yaw and velocity, some missed, some false,
    names confused now and then; every entry of ``compute()`` equal."""
    rng = np.random.default_rng(7)
    frames = []
    for _ in range(12):
        n = int(rng.integers(5, 30))
        gt = np.zeros((n, 9))
        gt[:, :3] = rng.uniform(-50, 50, (n, 3))
        gt[:, 3:6] = rng.uniform(0.4, 10, (n, 3))
        gt[:, 6] = rng.uniform(-np.pi, np.pi, n)
        gt[:, 7:9] = rng.normal(0, 3, (n, 2))
        names = rng.choice(DEFAULT_CLASSES, n).astype(object)
        keep = rng.random(n) < 0.8
        pred = gt[keep] + rng.normal(0, 0.4, (keep.sum(), 9)) * [1, 1, 0.2, 0.2, 0.2, 0.2,
                                                                 1, 1, 1]
        p_names = names[keep].copy()
        swap = rng.random(len(p_names)) < 0.1
        p_names[swap] = rng.choice(DEFAULT_CLASSES, swap.sum())
        false = np.column_stack([rng.uniform(-50, 50, (4, 3)), rng.uniform(0.5, 5, (4, 3)),
                                 rng.normal(0, 1, (4, 3))])
        pred = np.concatenate([pred, false])
        p_names = np.concatenate([p_names, rng.choice(DEFAULT_CLASSES, 4).astype(object)])
        frames.append((gt, names, pred, rng.random(len(pred)), p_names))
    m = _compute(DEFAULT_CLASSES, frames)
    assert sorted(m['per_class']) == sorted(DEFAULT_CLASSES)
    assert 0 < m['mAP'] < 1 and 0 < m['NDS'] < 1
