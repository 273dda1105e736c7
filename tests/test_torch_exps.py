"""The measuring helpers of ``mm_training_tpu_torch.exps`` on the CPU.

``timing.device_ops`` with torch.profiler stood in for by sessions of given
events: a session that records no device operation is taken again, up to
three sessions, then it raises. ``profile_nms.nms_rows``: each kind of K3
row has the shape it is timed for, checked through the plain NMS."""
import contextlib
import types
from unittest import mock

import pytest
import torch

from mm_training_tpu_torch.exps import profile_nms, timing
from mm_training_tpu_torch.ops import circle_nms

KERNEL = [('circle_nms_kernel', 1, 'CUDA'), ('cudaLaunchKernelExC', 1, 'CPU')]
EMPTY = [('aten::empty', 1, 'CPU')]


def _profiler(sessions):
    """A torch.profiler.profile whose n-th session records ``sessions[n]``,
    (name, count, device type) triples."""
    it = iter(sessions)

    @contextlib.contextmanager
    def profile(activities):
        events = [types.SimpleNamespace(key=k, count=n, device_type=types.SimpleNamespace(name=d))
                  for k, n, d in next(it)]
        yield types.SimpleNamespace(key_averages=lambda: events)
    return profile


def _device_ops(sessions):
    calls = []
    with mock.patch('torch.profiler.profile', _profiler(sessions)), \
            mock.patch.object(torch.cuda, 'synchronize', lambda: None):
        return timing.device_ops(lambda: calls.append(1)), len(calls)


@pytest.mark.parametrize('empty_first', [0, 1, 2])
def test_device_ops_profiles_again_after_an_empty_session(empty_first):
    ops, calls = _device_ops([EMPTY] * empty_first + [KERNEL])
    assert ops == {'circle_nms_kernel': 1}
    assert calls == 2 + empty_first          # the warm-up, then one call a session


def test_device_ops_keeps_a_session_with_device_events():
    """A session with device events is the measurement, however many."""
    two = KERNEL + [('Memcpy HtoD (Pageable -> Device)', 1, 'CUDA')]
    ops, calls = _device_ops([two, KERNEL])
    assert ops == {'circle_nms_kernel': 1, 'Memcpy HtoD (Pageable -> Device)': 1}
    assert calls == 2


def test_device_ops_raises_when_every_session_is_empty():
    with pytest.raises(RuntimeError, match='no device operation in 3 sessions'):
        _device_ops([EMPTY] * 3)


PC = (-204.8, -25.6, -5.0, 204.8, 25.6, 3.0)
THRESH = (4.0, 10.0, 0.5, 0.25)


@pytest.mark.parametrize('kind', ['uniform', 'objects', 'identical', 'chain'])
def test_nms_rows_kinds(kind):
    gen = torch.Generator().manual_seed(0)
    centers, scores, valid = profile_nms.nms_rows(kind, 96, PC, THRESH, gen)
    assert centers.shape == (4, 96, 2) and scores.shape == valid.shape == (4, 96)
    keep = circle_nms.circle_nms_mask(centers, scores, valid, THRESH)
    kept = keep.sum(1).tolist()
    if kind == 'identical':      # one box a row survives
        assert kept == [1, 1, 1, 1]
    elif kind == 'chain':        # every other box along the line
        assert valid.all() and kept == [48] * 4
        order = torch.argsort(centers[..., 0], dim=1)
        assert torch.equal(torch.gather(keep, 1, order),
                           (torch.arange(96) % 2 == 0).expand(4, -1))
    elif kind == 'objects':      # candidates gather around 24 objects
        assert all(k < v for k, v in zip(kept, valid.sum(1).tolist()))
    else:
        assert bool((centers[..., 0] >= PC[0]).all() and (centers[..., 0] <= PC[3]).all())


def test_device_ops_in_child_runs_the_named_calls_in_a_new_interpreter():
    """``timing.device_ops_in_child`` hands the named calls and their
    arguments to a fresh interpreter, which imports the functions, calls
    them and counts with ``device_ops``. On the CPU the count's device
    synchronize raises, after the warm-up call ran, and the child's error
    comes back; a call that fails in the child comes back the same way."""
    centers = torch.zeros(1, 2, 2, dtype=torch.int32)
    radii = torch.ones(1, 2, dtype=torch.int32)
    valid = torch.ones(1, 1, 2, dtype=torch.bool)
    with pytest.raises(RuntimeError, match='(?s)in device_ops.*not compiled with CUDA'):
        timing.device_ops_in_child([[('ops.gaussian', 'draw_heatmap',
                                      (centers, radii, valid, (4, 4)), {})]])
    with pytest.raises(RuntimeError, match='no_such_function'):
        timing.device_ops_in_child([[('ops.gaussian', 'no_such_function', (), {})]])


def test_profile_loader_reports_each_stage(capsys):
    """``exps/profile_loader.py`` at a small size: every stage timed, the
    loader's rate for each worker count, one JSON line."""
    import json

    from mm_training_tpu_torch.exps import profile_loader
    out = profile_loader.main(['--frames', '4', '--ground-points', '500', '--objects', '3',
                               '--workers', '1', '2'])
    assert out['frames'] == 4 and out['points_a_frame'] > 500
    assert all(out[k] > 0 for k in ('decode_ms', 'frame_ms', 'box_filter_ms', 'sample_ms'))
    assert out['frame_ms'] >= out['decode_ms'] and sorted(out['loader_samples_per_s']) == [1, 2]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])['frames'] == 4
