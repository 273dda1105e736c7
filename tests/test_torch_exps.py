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
