"""The comparison that decides ``correct`` fails the faults a cell can have
and the control, with the cells' own limits, at the tiny geometry: the run
as a scored run makes it, without the look for a card, the timed path broken
underneath."""
from types import SimpleNamespace

import pytest
import torch

from bench_tiny import run_tiny
from benchmark.harness.judge import PREDICT_NUMBERS, _fates

TIGHT = dict(dict.fromkeys(PREDICT_NUMBERS, 0), center_gap=1e-4, score_gap=1e-4, attr_gap_p99=1e-4)


@pytest.mark.parametrize('fault', ['state_unchanged', 'half_batch'])
@pytest.mark.parametrize('use_cam', [True, False])
def test_a_broken_train_step_is_not_correct(fault, use_cam):
    out = run_tiny('train', use_cam, 'lcr_train_b4', fault=fault)
    assert not out['correct'], out['numbers']


def test_an_altered_answer_is_not_correct():
    out = run_tiny('predict', True, 'lcr_predict_b4', fault='answer_altered')
    assert not out['correct'], out['numbers']


# At the tiny geometry every heatmap logit sits near its initial bias, so
# scores lie within the cell's score limit of one another and the kept
# set's rule is sure of few boxes: these faults are held to the tight
# limits that the port in float32 meets exactly (``TIGHT``).
@pytest.mark.parametrize('fault, number', [('valid_zeroed', 'missed_boxes'),
                                           ('nms_skipped', 'nms_pairs')])
def test_a_broken_decode_is_not_correct(fault, number):
    out = run_tiny('predict', True, 'lcr_predict_b4', fault=fault, limits=TIGHT)
    assert not out['correct'], out['numbers']
    assert out['numbers'][number] > 0, out['numbers']


def test_the_kept_set_rule_is_sure_only_beyond_the_moves():
    """Cell A outranks and suppresses B (1 m apart, radius 2 m); C is far.
    With small moves the rule is sure of each; with score moves that could
    swap A and B it is sure of neither."""
    conf = SimpleNamespace(
        bbox_coder=SimpleNamespace(max_num=3, score_threshold=0.0,
                                   post_center_range=[-50, -50, -10, 50, 50, 10]),
        test_cfg=SimpleNamespace(post_max_size=3))
    boxes = torch.zeros(3, 10)
    boxes[:, 0] = torch.tensor([0.0, 1.0, 10.0])
    boxes[:, 3:6] = 1.0
    scores = torch.tensor([0.9, 0.5, 0.35])
    kept, out, surv = _fates(boxes, scores, conf, 4.0, 0.01, 0.1)
    assert kept.tolist() == [True, False, True] and out.tolist() == [False, True, False]
    assert surv.tolist() == [True, False, True]
    kept, out, _ = _fates(boxes, scores, conf, 4.0, 0.3, 0.1)
    assert kept.tolist() == [False, False, True] and out.tolist() == [False, False, False]


@pytest.mark.parametrize('use_cam', [True, False])
def test_the_control_train_step_is_not_correct(use_cam):
    """The reference computed in float8 in the program's place."""
    out = run_tiny('train', use_cam, 'lcr_train_b4', side='control')
    assert not out['correct'], out['numbers']


def test_the_control_predict_step_is_not_correct():
    """At the tiny geometry the heads' inputs are small and every logit
    sits near the heatmap's initial bias, so float8 moves a box by
    thousandths of the cell's limits (which the card's runs at the cell's
    size set, PERF.md): held to ``TIGHT`` here, which the port in float32
    meets exactly (``test_bench_reference.py``)."""
    assert run_tiny('predict', True, 'lcr_predict_b4')['numbers'] == dict.fromkeys(TIGHT, 0.0)
    out = run_tiny('predict', True, 'lcr_predict_b4', side='control', limits=TIGHT)
    assert not out['correct'], out['numbers']
