"""The port's camera train step on nuScenes batches against the JAX
package's, mirroring the reference's slow nuScenes tests
(``tests/test_data/test_nuscenes_dataset.py``: the train step and eval end
to end, the camera key-frame sweeps, the depth-GT pipeline).

Each case is ``tests/torch_port_helpers.py::camera_train_parity_case`` on
the tiny nuScenes config of ``test_torch_nuscenes_slice.py`` (six cameras
with roll and pitch on the general splat, the six nuScenes tasks) and on
eval-mode batches of a ``exps/nuscenes_tree.py`` tree from each package's
dataset (the identity BEV augmentation: the helper's docstring says why
the float64 step needs it): the loss, the six-task head's and every other
gradient, the update and the BN statistics of the float64 step at the
helper's tolerances, the float32 step's losses as :func:`_check` says.
"""
import os
import shutil

import numpy as np
import pytest

from mm_training_tpu_torch.data import NUSC_CLASSES
from mm_training_tpu_torch.evaluation import NuScenesEvaluator
from mm_training_tpu_torch.exps.nuscenes_tree import write_nuscenes_tree
from mm_training_tpu_torch.scripts.gen_depth_gt import main as gen_depth_gt
from tests import torch_port_helpers as helpers
from tests.test_torch_nuscenes_slice import nuscenes_batches, nuscenes_config

pytestmark = pytest.mark.slow


def _config_fn(cfgmod, cfg):
    return nuscenes_config(cfgmod, **{k: getattr(cfg, k) for k in (
        'use_lidar', 'num_sweeps', 'use_depth_loss')})


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('nusc_train'))
    info = write_nuscenes_tree(root, splits={'train': 3}, img_hw=(90, 160), points=3000,
                               sweeps=2, anns=40)['info_paths']['train']
    return root, info


def _case(tree, dtype, indices=(0, 1), **kw):
    root, info = tree
    return helpers.camera_train_parity_case(
        dtype=dtype, rotated_bda=False, with_eval=dtype == np.float32 and kw.get(
            'use_lidar', True), config_fn=_config_fn,
        batch_fn=lambda jc, tc: nuscenes_batches(root, info, jc, tc, indices), **kw)


def _check(case, case64):
    """The float64 step at the helper's float64 tolerances: losses and the
    gradient norm to 1e-6 relative, every gradient
    (``check_train_gradients``), the update (``check_train_update``, both
    steps) and the BN statistics to 1e-5. The float32 step of these
    batches is ill-conditioned (40 boxes a sample under random weights: a
    detection loss in the thousands; measured on the first case, the JAX
    package's own float32 step is 0.5% from its float64 step in the depth
    loss and 4% in the gradient norm, and the two packages' float32 BN
    statistics 1.4e-3 apart while their float64 ones agree to 1e-10): its
    losses are held to 1e-3 relative (measured 5.7e-5 and 2.1e-4)."""
    j64, p64 = case64['j_metrics'], case64['p_metrics']
    j32, p32 = case['j_metrics'], case['p_metrics']
    assert j64['train_loss'] > 1.0 and j64['train_depth_loss'] > 1.0
    for k in ('train_loss', 'train_detection_loss', 'train_depth_loss', 'grad_norm'):
        assert abs(p64[k] - j64[k]) <= 1e-6 * j64[k], k
    for k in ('train_loss', 'train_detection_loss', 'train_depth_loss'):
        assert abs(p32[k] - j32[k]) <= 1e-3 * j32[k], k
    helpers.check_train_gradients(case64)
    helpers.check_train_update(case, case64)
    n = 0
    for name, got in case64['p_stats'].items():
        if name.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(got, case64['j_stats'][name], rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            n += 1
    assert n > 20


def test_nuscenes_train_step_and_eval_end_to_end(tree):
    """LiDAR + camera: a live depth loss from the LiDAR points; the six-task
    head's gradients; the eval step as the slice test holds it, and the
    port's evaluator gives a finite NDS over it."""
    case = _case(tree, np.float32)
    case64 = _case(tree, np.float64)
    _check(case, case64)
    assert case64['p_metrics']['train_depth_loss'] > 0
    assert any(n.startswith('head.task_heads.5.heatmap') for n in case64['p_mu'])
    helpers.check_eval_step(case)
    boxes, scores, labels, valid = case['p_eval'][1]
    ev = NuScenesEvaluator(NUSC_CLASSES)
    for i in range(1):                       # the second sample is padding (sample_valid)
        ev.update(boxes[i][valid[i]][:10], np.asarray(NUSC_CLASSES, object)[labels[i][valid[i]]
                                                                             [:10]],
                  boxes[i][valid[i]], scores[i][valid[i]],
                  np.asarray(NUSC_CLASSES, object)[labels[i][valid[i]]])
    assert np.isfinite(ev.compute()['NDS'])


def test_nuscenes_camera_key_frame_sweeps(tree):
    """``num_sweeps=2``: the previous key frame of the scene rides along as
    sweep 1 (samples 1 and 2; sample 1's partner is sample 0)."""
    case = _case(tree, np.float32, indices=(1, 2), num_sweeps=2)
    case64 = _case(tree, np.float64, indices=(1, 2), num_sweeps=2)
    _check(case, case64)


def test_nuscenes_depth_gt_pipeline(tmp_path):
    """Camera only, the LiDAR files removed: the depth bins of
    ``gen_depth_gt --dataset nuscenes`` reach the step as ``depth_gt``
    (K6's binning in the port), the depth loss real and different from the
    same batch's without them."""
    root = str(tmp_path)
    info = write_nuscenes_tree(root, splits={'train': 2}, img_hw=(90, 160), points=3000,
                               sweeps=2, anns=40)['info_paths']['train']
    gen_depth_gt(['--dataset', 'nuscenes', '--data-root', root, '--out', root,
                  '--split', 'train', '--workers', '1'])
    shutil.rmtree(os.path.join(root, 'sweeps'))
    shutil.rmtree(os.path.join(root, 'samples', 'LIDAR_TOP'))
    kw = dict(use_lidar=False, use_depth_loss=True)

    def batches(jc, tc):
        jc, tc = jc.replace(depth_gt_root=root), tc.replace(depth_gt_root=root)
        jb, b = nuscenes_batches(root, info, jc, tc)
        assert b['depth_gt'].shape == (2, 6, 4, 8) and (b['depth_gt'] > 0).any()
        assert not b['point_mask'].any()
        return jb, b

    cases = [helpers.camera_train_parity_case(
        dtype=dtype, rotated_bda=False, with_eval=False, config_fn=_config_fn,
        batch_fn=batches, **kw) for dtype in (np.float32, np.float64)]
    _check(*cases)

    def without(jc, tc):
        jb, b = batches(jc, tc)
        return ({k: v for k, v in jb.items() if k != 'depth_gt'},
                {k: v for k, v in b.items() if k != 'depth_gt'})

    bare = helpers.camera_train_parity_case(dtype=np.float64, rotated_bda=False,
                                            with_eval=False, config_fn=_config_fn,
                                            batch_fn=without, **kw)
    for c in (cases[1], bare):
        assert abs(c['p_metrics']['train_depth_loss'] - c['j_metrics']['train_depth_loss']) \
            <= 1e-6 * c['j_metrics']['train_depth_loss']
    assert abs(cases[1]['p_metrics']['train_depth_loss']
               - bare['p_metrics']['train_depth_loss']) > 1e-4
