"""The array layer of the evaluator (``evaluation/bev_map.py``).

The port's copy of ``mm_training_tpu/utils/universal.py``, numpy part: the
same names, cut to what the evaluator routes through. The JAX package's
second backend is jax.numpy; the port's is torch, whose tensors (on any
device) become numpy at :func:`to_numpy`, the evaluator's host boundary.
Every other function computes in numpy, as the JAX package's numpy branch
does, so the two evaluators give the same numbers on the same boxes.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ['is_tensor_or_ndarray', 'to_numpy', 'to_float', 'abs', 'cumsum', 'maximum',
           'minimum', 'clip', 'where', 'argsort', 'index_select', 'masked_select',
           'concatenate', 'stack']


def is_tensor_or_ndarray(t) -> bool:
    return isinstance(t, (np.ndarray, torch.Tensor))


def to_numpy(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def to_float(a):
    return a.astype(np.float32)


def abs(a):  # noqa: A001 - the reference's name
    return np.abs(a)


def cumsum(a, axis=None):
    return np.cumsum(a, axis=axis)


def minimum(a, b):
    return np.minimum(a, b)


def maximum(a, b):
    return np.maximum(a, b)


def where(condition, a, b):
    return np.where(condition, a, b)


def clip(a, a_min, a_max):
    return np.clip(a, a_min, a_max)


def argsort(a, axis):
    return np.argsort(a, axis=axis)


def index_select(array, indices, axis=0):
    return np.take(array, indices, axis=axis)


def masked_select(array, mask):
    return array[np.asarray(mask)]


def concatenate(arrays, axis=0):
    return np.concatenate(arrays, axis=axis)


def stack(arrays, axis=0):
    return np.stack(arrays, axis=axis)
