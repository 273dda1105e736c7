"""The port's Trainer on a camera config from an aiMotive tree with JPEG
images, on the CPU: a tiny ``exps.train`` run (2 steps, a sanity val, a
val each epoch, 'best' and 'latest' written, the test pass) whose best val
loss ``exps.evaluate`` reproduces; a ``depth_gt_root`` run whose step bins
the grids (K6's ``depth_grid_to_onehot``) and never projects the points;
and ``Trainer.validate`` against the JAX trainer's on carried weights
(``tiny_test_config(use_cam=True)`` at narrow widths, LiDAR, radar and two
cameras; random flax variables carried by
``models/weights.py::state_dict_from_flax``).

Tolerances of the parity: the losses (detection, depth, total) within 1e-5
relative, as ``tests/torch_port_helpers.py::check_eval_step`` holds one
camera eval step; every BEV metric within 1e-6 (the evaluator is the same
numpy on both sides, its inputs differ by float32 roundings)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mm_training_tpu.configs as jcfg
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu.data.synthetic import generate_synthetic_dataset
from mm_training_tpu.parallel import make_mesh
from mm_training_tpu.scripts import gen_depth_gt
from mm_training_tpu.training.train_step import TrainState as JState
from mm_training_tpu.training.trainer import Trainer as JTrainer
from mm_training_tpu_torch.exps import evaluate, train
from mm_training_tpu_torch.models import state_dict_from_flax
from mm_training_tpu_torch.ops import depth_labels as depth_label_ops
from mm_training_tpu_torch.training.trainer import Trainer
from tests import torch_port_helpers as helpers


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the steps are tiny, and the test workers already
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('aim_cam_trainer'))
    generate_synthetic_dataset(root, splits=('train', 'val'), frames_per_sequence=2,
                               n_objects=8, img_hw=(64, 128), image_detail=True,
                               lidar_format='laz', n_ground_points=3000)
    return root


def test_camera_train_cli_and_evaluate_reproduce(tree, tmp_path):
    """exps.train on lidar+radar+camera: 2 steps of one batch an epoch, so
    two vals; 'best' holds both steps and 'latest' step 2; exps.evaluate on
    'best' gives the recorded val loss of its best step."""
    out = str(tmp_path / 'train')
    common = ['--config', 'tiny_test_config', '--device', 'cpu', '--data-root', tree]
    overrides = ['use_cam=True', 'batch_size=2', 'num_workers=2']
    metrics = train.main(common + ['--max-steps', '2'] + overrides + [
        f'out_path={out!r}', 'num_sanity_val_steps=1', 'latest_every_n_steps=2',
        'log_every_n_steps=1'])
    assert np.isfinite(list(metrics.values())).all() and metrics['test_depth_loss'] > 0
    records = [json.loads(line) for line in open(os.path.join(out, 'metrics.jsonl'))]
    losses = [r['train_loss'] for r in records if 'train_loss' in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert sum('val_detection_loss' in r for r in records) == 2
    best = os.path.join(out, 'saved_models', 'best')
    assert sorted(os.listdir(best)) == ['1', '2']
    assert os.listdir(os.path.join(out, 'saved_models', 'latest')) == ['2']
    recorded = {int(d): json.load(open(os.path.join(best, d, 'metrics.json')))[
        'val_detection_loss'] for d in os.listdir(best)}
    want = min(recorded.values())
    ev = evaluate.main(common + overrides + [f'out_path={str(tmp_path / "eval")!r}',
                                             f'ckpt_path={best!r}'])
    assert abs(ev['test_detection_loss'] - want) <= 1e-5 * abs(want)


def test_depth_gt_root_train_bins_the_grids(tree, tmp_path, monkeypatch):
    """With depth_gt_root on the JAX package's grids, each train step bins
    the batch's grids (depth_grid_to_onehot) and projects no point
    (depth_labels is never called)."""
    grids = str(tmp_path / 'depth_gt')
    for split in ('train', 'val'):
        gen_depth_gt.main(['--data-root', tree, '--split', split, '--out', grids,
                           '--workers', '1', '--height', '64', '--width', '128'])
    calls = {'depth_grid_to_onehot': 0, 'depth_labels': 0}
    for name in calls:
        fn = getattr(depth_label_ops, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(depth_label_ops, name, counted)
    cfg = helpers.narrow_cam(tcfg, tcfg.tiny_test_config(
        use_cam=True, batch_size=2, num_workers=2, num_sanity_val_steps=0,
        out_path=str(tmp_path / 'out'), depth_gt_root=grids))
    tr = Trainer(cfg, data_root=tree, device='cpu')
    try:
        tr.setup()
        tr.fit(max_epochs=1)
    finally:
        tr.close()
    assert calls['depth_grid_to_onehot'] >= 2 and calls['depth_labels'] == 0


def test_validate_matches_jax_on_carried_weights(tree, tmp_path):
    kw = dict(use_cam=True, use_radar=True, batch_size=2, num_workers=2,
              num_sanity_val_steps=0)
    jc = helpers.narrow_cam(jcfg, jcfg.tiny_test_config(out_path=str(tmp_path / 'j'), **kw))
    tc = helpers.narrow_cam(tcfg, tcfg.tiny_test_config(out_path=str(tmp_path / 't'), **kw))
    jtr = JTrainer(jc, data_root=tree, mesh=make_mesh(jax.devices()[:1]))
    jtr.setup(steps_per_epoch=1)
    first = next(iter(jtr.loader('val')))
    b = {k: jnp.asarray(v) for k, v in first.items()
         if k not in ('path', 'n_valid', 'n_valid_global', 'sample_valid')}
    bb, s, n = b['imgs'].shape[:3]
    b['flipped'] = jnp.zeros((bb * s * n,), bool)
    v = helpers.random_variables(jtr.model.init, b, seed=5)
    jtr.state = JState(step=jnp.zeros((), jnp.int32), params=v['params'],
                       batch_stats=v['batch_stats'], opt_state=jtr.tx.init(v['params']))
    want = jtr.validate()

    tr = Trainer(tc, data_root=tree, device='cpu')
    tr.setup(steps_per_epoch=1)
    tr.init_state(next(iter(tr.loader('val'))))
    assert tr.cfg.get_backbone_conf().factorized_splat     # a virtualized rig: no switch
    tr.state.model.load_state_dict(state_dict_from_flax(v['params'], v['batch_stats'], tc))
    got = tr.validate()
    tr.close()

    assert set(got) == set(want)
    assert want['val_num_preds'] > 50 and want['val_depth_loss'] > 1.0
    losses = ('val_detection_loss', 'val_depth_loss', 'val_loss')
    for k in losses:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (k, got[k], want[k])
    for k in set(want) - set(losses):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
