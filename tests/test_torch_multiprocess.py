"""Data- and model-parallel training through the entry point (slow tier):
``exps.train`` under ``torchrun`` with 2 and 4 gloo CPU processes, and with
2 laid out as ``model_parallel=2``, against one process.

The port's counterpart of ``tests/test_parallel/test_multiprocess.py``: a
tree of 5 train and 5 val frames (the val split does not fill its last
global batch of 4, so the trailing batch is padded and sliced over the
ranks; with 4 ranks three of them hold only padding rows), the same global
batch of 4 in every run (``batch_size`` is a data rank's share), one epoch, the
test pass on 'best'. The pooled mAP must equal the one-process run's to
1e-9 (and the pooled predictions' count exactly) and the losses to 2e-4
relative; rank 0 alone writes ``config.json``,
the metrics log and the one checkpoint, and every val frame's JSON is
exported once."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _tree(tmp_path):
    from mm_training_tpu_torch.data import generate_synthetic_dataset
    return generate_synthetic_dataset(str(tmp_path / 'ds'), splits=('train', 'val'),
                                      frames_per_sequence=5, n_objects=4, write_images=False,
                                      lidar_format='laz', n_ground_points=800)


def _train(world, root, out, model_parallel=1):
    """The printed test metrics of ``exps.train`` on ``world`` processes
    (one process without ``torchrun``) laid out as ``model_parallel`` x
    data-parallel."""
    launch = ([sys.executable, '-m', 'torch.distributed.run', '--standalone',
               f'--nproc_per_node={world}'] if world > 1 else [sys.executable])
    argv = launch + ['-m', 'mm_training_tpu_torch.exps.train', '--config', 'tiny_test_config',
                     '--device', 'cpu', '--data-root', root, '--max-epochs', '1',
                     'use_cam=False', f'batch_size={4 * model_parallel // world}',
                     f'model_parallel={model_parallel}', 'num_workers=2',
                     'num_sanity_val_steps=0', 'latest_every_n_steps=0', f'out_path={out!r}']
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='2')
    run = subprocess.run(argv, env=env, capture_output=True, text=True, timeout=1500)
    if run.returncode:
        raise AssertionError(f'exps.train on {world} processes failed:\n{run.stdout[-3000:]}\n'
                             f'{run.stderr[-5000:]}')
    lines = run.stdout.splitlines()
    start = max(i for i, line in enumerate(lines) if line == '{')
    assert sum(line == '{' for line in lines) == 1, 'only rank 0 prints the metrics'
    return json.loads('\n'.join(lines[start:lines.index('}', start) + 1]))


def _check_outputs(out, n_val):
    """One checkpoint, one config, one metrics log; each val frame exported once."""
    out = Path(out)
    steps = os.listdir(out / 'saved_models' / 'best')
    assert steps == ['1'], steps
    assert sorted(os.listdir(out / 'saved_models' / 'best' / '1')) == ['metrics.json',
                                                                      'state.pt']
    assert (out / 'config.json').is_file()
    assert len(list(out.rglob('metrics.jsonl'))) == 1
    assert len(list((out / 'outputs').rglob('*.json'))) == n_val


def _compare(tmp_path, world, model_parallel=1):
    root = _tree(tmp_path)
    m1 = _train(1, root, str(tmp_path / 'out1'))
    mn = _train(world, root, str(tmp_path / f'out{world}'), model_parallel)
    for out in ('out1', f'out{world}'):
        _check_outputs(tmp_path / out, 5)
    assert 'test_ap_auc' in m1 and 'test_ap_auc' in mn
    for k in ('test_ap_auc', 'test_ap_interp', 'test_recall_2d'):
        assert mn[k] == pytest.approx(m1[k], abs=1e-9), k
    for k in ('test_detection_loss', 'test_loss'):
        assert mn[k] == pytest.approx(m1[k], rel=2e-4), k
    # after one step of a random init the APs are 0 in both runs: the pooled
    # predictions are compared by their count and operating-point score too
    assert mn['test_num_preds'] == m1['test_num_preds'] > 100
    assert mn['test_score_op'] == pytest.approx(m1['test_score_op'], rel=1e-4)


@pytest.mark.slow
def test_two_process_training_matches_single(tmp_path):
    _compare(tmp_path, 2)


@pytest.mark.slow
def test_four_process_training_matches_single(tmp_path):
    """4 ranks of one row each: on the padded trailing val batch ranks 1-3
    hold only padding rows."""
    _compare(tmp_path, 4)


@pytest.mark.slow
def test_model_parallel_training_matches_single(tmp_path):
    """2 ranks laid out as ``model_parallel=2``: both read the whole global
    batch and run the head on a W half of it. The test pass pools over the
    data group alone and model index 0 exports, so each prediction is
    counted once and each val frame's JSON written once."""
    _compare(tmp_path, 2, model_parallel=2)
