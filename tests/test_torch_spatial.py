"""The halo exchanges of ``parallel/spatial.py`` and the W-sharded head.

A gloo world of 2 and one of 4 CPU processes (``parallel/dryrun.py::
spawn_ranks``, ``model_parallel`` = the world) run
``tests/torch_mp_worker.py::spatial_cases`` at once: each op of the head that
reads beyond its own columns (the 3x3/1 and 3x3/2 convs, the 7x7/2 stem, the
3x3/2 max-pool) on a W shard in float64, against the unsharded op in this
process, forward and input gradient (1e-12: the same products, summed in
another order); and on 2 ranks the narrow tiny ``BEVDepthHead`` in train and
eval mode on W shards of a [2, 16, 32, 64] BEV in float64: in eval mode its
gathered maps and input gradient against the JAX head's ``apply`` and
``jax.vjp`` on the whole map (weights through ``models/weights.py``), in both
modes against the port's unsharded head (with the parameter gradients summed
over the ranks and the BatchNorm statistics).
"""
import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mm_training_tpu.configs as jcfg
from mm_training_tpu.models.centerpoint_head import BEVDepthHead as JHead
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu_torch.models import weights
from mm_training_tpu_torch.parallel import dryrun, spatial
from mm_training_tpu_torch.parallel.mesh import Axis
from tests import torch_mp_worker as cases
from tests.torch_port_helpers import narrow, random_variables

WORLDS = (2, 4)


def _head_inputs():
    """(the port's head conf, its float64 state dict, x NHWC, the cotangent
    maps) and a function giving the JAX head's eval-mode (maps, d x) in
    float64 (x64 on for its call only)."""
    jm = JHead(narrow(jcfg, jcfg.tiny_test_config(use_cam=False)).get_head_conf())
    hconf = narrow(tcfg, tcfg.tiny_test_config(use_cam=False)).get_head_conf()
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 16, 32, 64))
    v = random_variables(jm.init, jnp.asarray(x, jnp.float32), seed=22)
    state = {k: t.double() for k, t in weights.bev_head_state_dict(
        v['params'], v['batch_stats'], hconf).items()}
    shapes = jax.eval_shape(functools.partial(jm.apply, v, train=False),
                            jnp.asarray(x, jnp.float32))
    cot = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape), shapes)

    def jax_head():
        with jax.enable_x64(True):
            v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)

            def maps_and_dx(xx, c):
                maps, vjp = jax.vjp(functools.partial(jm.apply, v64, train=False), xx)
                return maps, vjp(c)[0]
            maps, dx = jax.jit(maps_and_dx)(jnp.asarray(x), cot)
            return jax.tree_util.tree_map(np.asarray, maps), np.asarray(dx)
    return (hconf, state, x, [{k: np.asarray(c[k]) for k in c} for c in cot]), jax_head


@pytest.fixture(scope='module')
def worlds():
    """({world: each rank's results}, the one-process results, the JAX
    head's results)."""
    head_spec, jax_head = _head_inputs()
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {w: pool.submit(dryrun.spawn_ranks, w, 'tests.torch_mp_worker:spatial_cases',
                                  (head_spec if w == 2 else None,), device='cpu',
                                  model_parallel=w)
                   for w in WORLDS}
        want = jax_head()
        single = cases.spatial_cases(head_spec)
        return {w: f.result() for w, f in futures.items()}, single, want


@pytest.mark.parametrize('op', [name for name, *_ in cases.HALO_OPS])
@pytest.mark.parametrize('world', WORLDS)
def test_halo_op_matches_the_unsharded_op(worlds, world, op):
    """The ranks' output shards concatenate to the unsharded output and
    their input-gradient shards to its input gradient (float64, 1e-12)."""
    ranks, single, _ = worlds
    want = single['halo'][op]
    for key in ('y', 'dx'):
        got = np.concatenate([r['halo'][op][key] for r in ranks[world]], axis=-1)
        assert got.shape == want[key].shape
        np.testing.assert_allclose(got, want[key], rtol=1e-12, atol=1e-12, err_msg=key)


def _gathered(got, t, name):
    return np.concatenate([g['maps'][t][name] for g in got], axis=2)


def test_sharded_head_matches_jax(worlds):
    """The tiny head in eval mode on two W shards: the gathered maps and the
    input gradient (every model peer holds the whole of it) equal the JAX
    head's on the whole map, to 1e-5 relative (the port's eval BatchNorm
    takes its scale and shift in float32, the JAX head in float64 here);
    the parameter gradients summed over the ranks equal the port's
    unsharded head's (1e-9)."""
    ranks, single, (want_maps, want_dx) = worlds
    got = [r['head_eval'] for r in ranks[2]]
    for t, want_task in enumerate(want_maps):
        for name, w in want_task.items():
            np.testing.assert_allclose(_gathered(got, t, name), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(), err_msg=name)
    for g in got:
        np.testing.assert_allclose(g['dx'], want_dx, rtol=1e-5,
                                   atol=1e-5 * np.abs(want_dx).max())
    for name, w in single['head_eval']['dparams'].items():
        np.testing.assert_allclose(sum(g['dparams'][name] for g in got), w, rtol=1e-9,
                                   atol=1e-9 * max(np.abs(w).max(), 1.0), err_msg=name)


def test_sharded_head_train_mode_matches_unsharded(worlds):
    """The tiny head in train mode on two W shards (BatchNorm statistics of
    the whole map, from every shard's moments): the gathered maps, the
    input gradient and the summed parameter gradients equal the port's
    unsharded head's to 1e-9, its running statistics to 1e-12 (float64;
    the unsharded head is held to the JAX head in train mode through the
    train-step parity tests)."""
    ranks, single, _ = worlds
    want, got = single['head_train'], [r['head_train'] for r in ranks[2]]
    for t, want_task in enumerate(want['maps']):
        for name, w in want_task.items():
            np.testing.assert_allclose(_gathered(got, t, name), w, rtol=1e-9,
                                       atol=1e-9 * np.abs(w).max(), err_msg=name)
    for g in got:
        np.testing.assert_allclose(g['dx'], want['dx'], rtol=1e-9,
                                   atol=1e-9 * np.abs(want['dx']).max())
        for name, w in want['stats'].items():
            np.testing.assert_allclose(g['stats'][name], w, rtol=1e-12, atol=1e-12,
                                       err_msg=name)
    for name, w in want['dparams'].items():
        np.testing.assert_allclose(sum(g['dparams'][name] for g in got), w, rtol=1e-9,
                                   atol=1e-9 * max(np.abs(w).max(), 1.0), err_msg=name)


def test_halo_widths_follow_the_op():
    """Each halo from (kernel, stride, padding, dilation): the 3x3/1 conv
    reads a column on each side, the 3x3/2 conv and max-pool one on the
    left, the 7x7/2 stem 3 and 2, a 1x1/2 conv and a kernel = stride conv
    none, a dilated 3x3 its dilation."""
    assert spatial.halo(3, 1, 1) == (1, 1)
    assert spatial.halo(3, 2, 1) == (1, 0)
    assert spatial.halo(7, 2, 3) == (3, 2)
    assert spatial.halo(1, 2, 0) == (0, 0)
    assert spatial.halo(2, 2, 0) == (0, 0)
    assert spatial.halo(3, 1, 2, dilation=2) == (2, 2)


def test_misaligned_width_raises_naming_model_parallel():
    """A BEV whose width does not split into shards of whole total strides,
    or a halo wider than a shard, raises naming ``model_parallel``; without
    a model axis nothing is checked."""
    axis = Axis(None, 0, 2)
    spatial.check_columns(64, 16, axis)
    spatial.check_columns(40, 16, None)
    with pytest.raises(ValueError, match='model_parallel=2'):
        spatial.check_columns(48, 16, axis)
    with pytest.raises(ValueError, match='lower model_parallel'):
        spatial.halo_pad(torch.zeros(1, 1, 1, 2), 3, 2, axis)
