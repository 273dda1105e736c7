"""The nuScenes slice as a whole on the CPU: the port's eval step against the
JAX package's on a nuScenes batch, then both evaluators.

The tiny camera + LiDAR config at narrow widths on a raw rig (the general
splat), with BEVDepth's six nuScenes tasks (``configs.nuscenes_tasks``:
tasks of one and of two classes, six NMS radii) and six cameras; a batch of
two samples of a ``exps/nuscenes_tree.py`` tree (cameras with roll and
pitch, LiDAR sweeps, all ten classes) from each package's
``NuscMVDetDataset`` (byte-equal, ``test_torch_nuscenes_dataset.py``); the
same random flax variables carried into the port (``models/weights.py``).
Losses, boxes, scores and labels are held as
``tests/torch_port_helpers.py::check_eval_step`` holds them; each
package's ``NuScenesEvaluator`` on its own outputs gives the same APs, and
TP errors and NDS within the boxes' 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mm_training_tpu.configs as jcfg
from mm_training_tpu.data.aimotive_dataset import collate_aim as j_collate
from mm_training_tpu.data.nuscenes_dataset import NuscMVDetDataset as JDataset
from mm_training_tpu.evaluation.nuscenes_eval import NuScenesEvaluator as JEvaluator
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu_torch.data import NUSC_CLASSES, NuscMVDetDataset, collate_aim
from mm_training_tpu_torch.evaluation import NuScenesEvaluator
from mm_training_tpu_torch.exps.nuscenes_tree import write_nuscenes_tree
from tests import torch_port_helpers as helpers

CAMS = ('CAM_FRONT_LEFT', 'CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_BACK_LEFT', 'CAM_BACK',
        'CAM_BACK_RIGHT')


def nuscenes_config(cfgmod, **kw):
    """Either package's tiny nuScenes config: narrow camera + LiDAR widths,
    six cameras, the general splat and the six nuScenes tasks (the port's
    ``configs.nuscenes_tasks``, built from either package's dataclasses)."""
    kw = dict(dict(use_cam=True, use_lidar=True, use_radar=False, num_cameras=6), **kw)
    cfg = helpers.raw_rig(helpers.narrow_cam(cfgmod, cfgmod.tiny_test_config(**kw)))
    head = cfg.get_head_conf()
    return cfg.replace(head_conf=dataclasses.replace(
        head, tasks=tuple(cfgmod.TaskConf(len(c), c) for c in tcfg.NUSC_TASK_CLASSES),
        test_cfg=dataclasses.replace(head.test_cfg, min_radius=tcfg.NUSC_MIN_RADIUS)))


def nuscenes_batches(root, info_path, jc, tc, indices=(0, 1), is_train=False):
    """(JAX batch, port batch) of ``indices`` from each package's dataset;
    every array equal."""
    jds = JDataset(info_path, jc, data_root=root, cams=CAMS, is_train=is_train)
    ds = NuscMVDetDataset(info_path, tc, data_root=root, cams=CAMS, is_train=is_train)
    jb = j_collate([jds[i] for i in indices])
    b = collate_aim([ds[i] for i in indices])
    assert jb.pop('path') == b.pop('path')
    assert sorted(jb) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(b[k], jb[k])
    return jb, b


@pytest.fixture(scope='module')
def case(tmp_path_factory):
    from mm_training_tpu.models import BEVDepthLiDAR as JModel
    from mm_training_tpu.training.train_step import TrainState
    from mm_training_tpu.training.train_step import make_eval_step as j_eval_step
    from mm_training_tpu_torch.models import BEVDepthLiDAR, state_dict_from_flax
    from mm_training_tpu_torch.training import create_train_state, make_eval_step

    root = str(tmp_path_factory.mktemp('nusc_slice'))
    tree = write_nuscenes_tree(root, splits={'val': 2}, img_hw=(90, 160), points=3000,
                               sweeps=2, anns=40)
    jc, tc = nuscenes_config(jcfg), nuscenes_config(tcfg)
    jbatch, batch = nuscenes_batches(root, tree['info_paths']['val'], jc, tc)
    assert batch['gt_mask'].sum() > 20 and len(np.unique(batch['gt_labels'][batch['gt_mask']])) > 6

    jm = JModel(jc)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    v = helpers.random_variables(jm.init, dict(jb, flipped=jnp.zeros((12,), bool)), seed=4)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                        batch_stats=v['batch_stats'], opt_state=None)
    j_eval = jax.tree_util.tree_map(np.asarray, j_eval_step(jc, jm)(jstate, jb))
    model = BEVDepthLiDAR(tc, device='cpu')
    model.load_state_dict(state_dict_from_flax(v['params'], v['batch_stats'], tc))
    p_eval = make_eval_step(tc)(create_train_state(tc, model, steps_per_epoch=10), batch)
    p_eval = jax.tree_util.tree_map(lambda t: t.numpy(), p_eval)
    return {'j_eval': j_eval, 'p_eval': p_eval, 'camera': True, 'batch': batch, 'cfg': tc}


def test_nuscenes_eval_step_matches_jax(case):
    """Six tasks: 6 x 83 box slots a sample, every label id of the ten
    classes possible; the eval losses, depth viz, boxes, scores and labels
    within the tolerances of ``check_eval_step``."""
    boxes, _, labels, valid = case['p_eval'][1]
    assert boxes.shape == (2, 6 * 83, 9)
    assert labels[valid].max() < 10 and len(np.unique(labels[valid])) >= 6
    helpers.check_eval_step(case)


def test_nuscenes_evaluators_agree_on_the_eval_step(case):
    """Each package's evaluator over its own eval step's boxes (label ids
    named by ``NUSC_CLASSES``): the same per-class APs and mAP, the TP
    errors and NDS within 1e-3."""
    batch = case['batch']
    results = []
    for evaluator, (boxes, scores, labels, valid) in (
            (NuScenesEvaluator(NUSC_CLASSES), case['p_eval'][1]),
            (JEvaluator(NUSC_CLASSES), case['j_eval'][1])):
        for i in range(2):
            gm, v = batch['gt_mask'][i], valid[i]
            evaluator.update(batch['gt_boxes'][i][gm],
                             np.asarray(NUSC_CLASSES, object)[batch['gt_labels'][i][gm]],
                             boxes[i][v], scores[i][v],
                             np.asarray(NUSC_CLASSES, object)[labels[i][v]])
        results.append(evaluator.compute())
    got, want = results
    assert np.isfinite([got[k] for k in ('mAP', 'NDS', 'mATE', 'mASE', 'mAOE', 'mAVE')]).all()
    assert got['mAP'] == want['mAP']
    for cls in NUSC_CLASSES:
        assert got['per_class'][cls]['ap'] == want['per_class'][cls]['ap'], cls
    for k in ('NDS', 'mATE', 'mASE', 'mAOE', 'mAVE', 'mAAE'):
        assert abs(got[k] - want[k]) <= 1e-3, k


def test_decode_needs_a_radius_a_task():
    """Six tasks with the aiMotive head's four radii: the JAX decode fails
    indexing them (``min_radius[t]``, mm_training_tpu/models/
    centerpoint_head.py:320, IndexError at the fifth task), and the port's
    refuses, naming the knob."""
    from mm_training_tpu_torch.models.centerpoint_head import decode_boxes
    conf = nuscenes_config(tcfg).get_head_conf()
    conf = dataclasses.replace(conf, test_cfg=dataclasses.replace(
        conf.test_cfg, min_radius=(4, 10, 0.5, 0.25)))
    preds = [{'heatmap': torch.zeros(1, 8, 8, t.num_class), 'reg': torch.zeros(1, 8, 8, 2),
              'height': torch.zeros(1, 8, 8, 1), 'dim': torch.zeros(1, 8, 8, 3),
              'rot': torch.zeros(1, 8, 8, 2), 'vel': torch.zeros(1, 8, 8, 2)}
             for t in conf.tasks]
    conf = dataclasses.replace(conf, bbox_coder=dataclasses.replace(conf.bbox_coder,
                                                                    max_num=32))
    with pytest.raises(ValueError, match='min_radius holds 4 radii for 6 tasks'):
        decode_boxes(conf, preds)
