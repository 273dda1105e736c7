"""The port's rank layout (``parallel/mesh.py``) against the JAX package's
``make_mesh``, and the four cases of ``tests/test_parallel/test_multislice.py``
on ranks.

A rank of the port is a device of JAX's ``make_mesh`` whose ``id`` is the
rank and whose ``slice_index`` is its node (``_FakeDev``, as the JAX test
fakes them); the port's layout of a world of 8 must be JAX's mesh of those
devices, given in rank order, for every (model_parallel, num_slices) of (1,
1), (2, 1), (1, 2) and (2, 2), with the nodes shuffled, without node
information (CPU devices), and with fewer nodes than slices (both warn).
"""
import warnings
from unittest import mock

import numpy as np
import pytest

from mm_training_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu_torch import parallel
from mm_training_tpu_torch.parallel import mesh

WORLD = 8
KNOBS = [(1, 1), (2, 1), (1, 2), (2, 2)]


class _FakeDev:
    """Stand-in with the TPU device attributes make_mesh reads."""

    def __init__(self, id, slice_index):
        self.id = id
        self.slice_index = slice_index

    def __repr__(self):
        return f'dev(id={self.id}, slice={self.slice_index})'


def _shuffled_nodes(seed, n_nodes=2):
    nodes = [r % n_nodes for r in range(WORLD)]
    np.random.RandomState(seed).shuffle(nodes)
    return nodes


def _jax_ranks(m, s, nodes):
    devs = [_FakeDev(r, None if nodes is None else nodes[r]) for r in range(WORLD)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        jmesh = make_mesh(devs, model_parallel=m, num_slices=s)
    assert jmesh.shape == {MODEL_AXIS: m, DATA_AXIS: WORLD // m}
    return np.vectorize(lambda d: d.id)(np.asarray(jmesh.devices)), len(caught)


@pytest.mark.parametrize('nodes', ['shuffled', 'none', 'one_node'])
@pytest.mark.parametrize('m,s', KNOBS)
def test_layout_equals_jax_make_mesh(m, s, nodes):
    """The same rank at every (model, data) place as JAX's device id, and a
    warning exactly where JAX warns (slices asked of fewer nodes)."""
    node_of = {'shuffled': _shuffled_nodes(m * 10 + s), 'none': None,
               'one_node': [0] * WORLD}[nodes]
    want, jax_warned = _jax_ranks(m, s, node_of)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        got = parallel.mesh_layout(WORLD, m, s, node_of)
    np.testing.assert_array_equal(got, want)
    assert len(caught) == jax_warned == (1 if s > 1 and nodes == 'one_node' else 0)


def test_layout_real_slice_indices_group_slice_outermost():
    """8 ranks on 2 nodes, interleaved and shuffled: each node's ranks are
    contiguous along the data axis (slice-major), ascending within a
    node."""
    nodes = _shuffled_nodes(0)
    arr = parallel.mesh_layout(WORLD, 2, 2, nodes)
    assert arr.shape == (2, 4)
    for row in arr:
        assert [nodes[r] for r in row] == [nodes[arr[0, 0]]] * 2 + [1 - nodes[arr[0, 0]]] * 2
    ids0 = [r for r in arr.flatten() if nodes[r] == 0]
    assert ids0 == sorted(ids0)


def test_layout_virtual_slices_are_contiguous_groups():
    """Without node information the slices are contiguous halves, the
    ranks in their order."""
    np.testing.assert_array_equal(parallel.mesh_layout(WORLD, 1, 2), np.arange(8)[None])


@pytest.mark.parametrize('m,s', [(1, 3), (3, 1), (0, 1), (1, 0)])
def test_knobs_must_divide_the_world(m, s):
    """A world the two knobs do not divide, or a knob under 1, raises
    naming the knob."""
    with pytest.raises(ValueError, match='model_parallel' if s else 'num_slices'):
        parallel.mesh_layout(WORLD, m, s)


def _as_rank(rank, world=WORLD):
    return (mock.patch.object(mesh, 'process_index', lambda: rank),
            mock.patch.object(mesh, 'process_count', lambda: world))


def test_trainer_builds_sliced_mesh_from_config(tmp_path):
    """``Config.num_slices`` and ``model_parallel`` reach the trainer's
    layout (the production entry: ``exps.train`` builds ``Trainer(cfg)``);
    in one process a knob the world does not divide raises, naming it."""
    from mm_training_tpu_torch.training.trainer import Trainer
    try:
        for m, s, want in ((1, 2, np.arange(8)[None]), (2, 1, np.arange(8).reshape(2, 4))):
            cfg = tcfg.tiny_test_config(use_cam=False, batch_size=1, model_parallel=m,
                                        num_slices=s, out_path=str(tmp_path))
            a, b = _as_rank(3)
            with a, b, mock.patch('torch.distributed.is_initialized', lambda: False):
                tr = Trainer(cfg, data_root='/nonexistent-not-touched-before-setup',
                             device='cpu')
                np.testing.assert_array_equal(tr.mesh.layout, want)
                assert tr.data_parallel_size == WORLD // m
                assert parallel.data_index() == 3
                assert parallel.model_index() == 0
                tr.close()
        with pytest.raises(ValueError, match='model_parallel=2 x num_slices=1'):
            Trainer(tcfg.tiny_test_config(use_cam=False, model_parallel=2,
                                          out_path=str(tmp_path)), device='cpu')
    finally:
        parallel.reset_mesh()


@pytest.mark.parametrize('m,s', KNOBS)
def test_batch_bounds_follow_the_data_index(m, s):
    """Each rank's rows of a global batch of 8 x data-parallel size are its
    data index's share; model peers hold the same rows, the data ranks'
    rows tile the batch once."""
    layout = parallel.mesh_layout(WORLD, m, s)
    dp = WORLD // m
    seen = {}
    try:
        for rank in range(WORLD):
            a, b = _as_rank(rank)
            with a, b, mock.patch('torch.distributed.is_initialized', lambda: False):
                parallel.make_mesh(m, s)
                i, j = np.argwhere(layout == rank)[0]
                assert (parallel.model_index(), parallel.data_index()) == (i, j)
                assert parallel.data_parallel_size() == dp
                lo, hi = parallel.process_batch_bounds(8 * dp)
                assert (lo, hi) == (8 * j, 8 * j + 8)
                seen.setdefault((lo, hi), set()).add(i)
    finally:
        parallel.reset_mesh()
    assert sorted(seen) == [(8 * j, 8 * j + 8) for j in range(dp)]
    assert all(v == set(range(m)) for v in seen.values())


@pytest.mark.parametrize('kw', [{}, dict(model_parallel=2, use_cam=False)])
def test_dryrun_config_equals_jax(kw):
    """``parallel/dryrun.py::dryrun_config`` is the JAX harness's slim
    geometry, field for field."""
    import dataclasses

    from mm_training_tpu.parallel.dryrun import dryrun_config as jax_dryrun_config
    from mm_training_tpu_torch.parallel.dryrun import dryrun_config
    assert (dataclasses.asdict(dryrun_config(**kw))
            == dataclasses.asdict(jax_dryrun_config(**kw)))


@pytest.mark.parametrize('builder', ['create_train_state', 'make_train_step', 'make_eval_step',
                                     'make_predict_step', 'make_state_predict_step'])
def test_steps_refuse_a_config_the_mesh_does_not_lay_out(builder):
    """The steps read the layout from the mesh, so each builder raises,
    naming ``model_parallel``, for a config whose knob the mesh does not
    have: ``model_parallel=2`` in one process without a mesh, and 1 on a
    rank of a world of 8 laid out as (2, 4); the (2, 4) rank builds the
    config of 2."""
    from mm_training_tpu_torch import training
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    cfg = tcfg.tiny_test_config(use_cam=False, batch_size=1)
    model = BEVDepthLiDAR(cfg, device='cpu')

    def build(c):
        fn = getattr(training, builder)
        return fn(c, model) if builder in ('create_train_state', 'make_predict_step') else fn(c)
    with pytest.raises(ValueError, match='model_parallel=2 but the ranks are laid out with '
                                         'model_parallel=1'):
        build(cfg.replace(model_parallel=2))
    a, b = _as_rank(3)
    try:
        with a, b, mock.patch('torch.distributed.is_initialized', lambda: False):
            parallel.make_mesh(2)
            with pytest.raises(ValueError, match='model_parallel=1 but the ranks are laid out '
                                                 'with model_parallel=2'):
                build(cfg)
            build(cfg.replace(model_parallel=2))
    finally:
        parallel.reset_mesh()
