"""The port's ``Trainer.validate`` against the JAX package's on the same
weights and the same dataset tree (CPU, ``tiny_test_config`` at narrow
widths, LiDAR+radar; random flax variables carried over by
``models/weights.py::state_dict_from_flax``). A file of its own: the JAX
eval step's compile is most of its time.

Tolerances: the losses within 1e-5 relative (the eval step's, as
``tests/torch_port_helpers.py::check_eval_step`` holds them); every BEV
metric within 1e-6: the evaluator's numpy arithmetic is the same on both
sides, and its inputs differ by the decode's float32 roundings (scores to
~1e-6; ``score_op`` is a score). A random init matches no ground truth, so
the AP metrics are 0 on both sides here; ``tests/test_torch_eval_map.py``
holds the evaluator itself to the JAX package's on boxes that match."""
import jax
import jax.numpy as jnp
import pytest

import mm_training_tpu.configs as jcfg
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu.data.synthetic import generate_synthetic_dataset
from mm_training_tpu.parallel import make_mesh
from mm_training_tpu.training.train_step import TrainState as JState
from mm_training_tpu.training.trainer import Trainer as JTrainer
from mm_training_tpu_torch.models import state_dict_from_flax
from mm_training_tpu_torch.training.trainer import Trainer
from tests import torch_port_helpers as helpers


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('aim_validate'))
    generate_synthetic_dataset(root, splits=('train', 'val'), frames_per_sequence=3,
                               n_objects=8, write_images=False, lidar_format='laz',
                               n_ground_points=3000)
    return root


def test_validate_matches_jax_on_carried_weights(tree, tmp_path):
    kw = dict(use_cam=False, use_radar=True, batch_size=2, num_workers=2,
              num_sanity_val_steps=0, point_cloud_range=(-51.2, -25.6, -5.0, 51.2, 25.6, 3.0))
    jc = helpers.narrow(jcfg, jcfg.tiny_test_config(out_path=str(tmp_path / 'j'), **kw))
    tc = helpers.narrow(tcfg, tcfg.tiny_test_config(out_path=str(tmp_path / 't'), **kw))
    jtr = JTrainer(jc, data_root=tree, mesh=make_mesh(jax.devices()[:1]))
    jtr.setup(steps_per_epoch=1)
    first = next(iter(jtr.loader('val')))
    b = {k: jnp.asarray(v) for k, v in first.items()
         if k not in ('path', 'n_valid', 'n_valid_global', 'sample_valid')}
    b['flipped'] = jnp.zeros((jc.batch_size,), bool)
    v = helpers.random_variables(jtr.model.init, b, seed=5)
    # the state as Trainer.init_state builds it, without tracing the init
    jtr.state = JState(step=jnp.zeros((), jnp.int32), params=v['params'],
                       batch_stats=v['batch_stats'], opt_state=jtr.tx.init(v['params']))
    want = jtr.validate()

    tr = Trainer(tc, data_root=tree, device='cpu')
    tr.setup(steps_per_epoch=1)
    tr.init_state(next(iter(tr.loader('val'))))
    tr.state.model.load_state_dict(state_dict_from_flax(v['params'], v['batch_stats'], tc))
    got = tr.validate()
    tr.close()

    assert set(got) == set(want)
    assert want['val_num_preds'] > 50                 # the comparison has substance
    for k in ('val_detection_loss', 'val_loss'):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got[k], want[k])
    for k in set(want) - {'val_detection_loss', 'val_loss'}:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
