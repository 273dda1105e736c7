"""The port's Trainer (``training/trainer.py``) on the CPU, on
``tiny_test_config`` at narrow widths over a small aiMotive tree: its
checkpoints (layout, top-k by metric, restore, resume), K-step groups, the
test pass's export, and the slow counterparts of
``tests/test_training/test_trainer_e2e.py`` and ``test_preemption.py``.
Its parity with the JAX trainer's ``validate`` is
``tests/test_torch_trainer_parity.py``.

Run as a script (``python tests/test_torch_trainer.py ROOT OUT MAX_STEPS
RESULT``), this file is the preemption test's worker."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

if __name__ == '__main__':       # the preemption worker: the repository on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import mm_training_tpu_torch.configs as tcfg  # noqa: E402
from mm_training_tpu_torch.data import generate_synthetic_dataset  # noqa: E402
from mm_training_tpu_torch.training.trainer import Trainer, _pick_restore_step  # noqa: E402


def _narrow(cfg):
    """tests/torch_port_helpers.py::narrow, without importing JAX (the
    preemption worker runs this file alone)."""
    import dataclasses
    lconf = dataclasses.replace(
        cfg.get_lidar_conf(), encoder_channels=((8, 8, 16), (16, 16, 32), (32, 32, 64), (64, 64)),
        out_channels=64)
    head = dataclasses.replace(
        cfg.get_head_conf(),
        bev_backbone_conf=tcfg.BEVBackboneConf(in_channels=64, base_channels=32),
        bev_neck_conf=tcfg.BEVNeckConf(in_channels=(32, 64, 128), out_channels=(16, 16, 16)),
        in_channels=48)
    return cfg.replace(lidar_conf=lconf, head_conf=head)


def _cfg(out, **kw):
    base = dict(use_cam=False, use_lidar=True, use_radar=True, batch_size=1, num_workers=2,
                num_sanity_val_steps=0, out_path=str(out), latest_every_n_steps=2,
                log_every_n_steps=1)
    base.update(kw)
    return _narrow(tcfg.tiny_test_config(**base))


def _trainer(cfg, root):
    tr = Trainer(cfg, data_root=root, device='cpu')
    tr.setup()
    return tr


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op thread: the steps here are tiny, and the test workers
    already share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('aim_trainer'))
    generate_synthetic_dataset(root, splits=('train', 'val'), frames_per_sequence=4,
                               n_objects=6, write_images=False, lidar_format='laz',
                               n_ground_points=1000)
    return root


def _steps(path):
    return sorted(int(d) for d in os.listdir(path) if d.isdigit())


def test_fit_writes_best_and_latest_then_resume_at_max_steps_runs_nothing(tree, tmp_path):
    """fit for 2 steps (2 batches of 2 an epoch) writes 'best' (the epoch's
    end) and 'latest' (every step, one kept), each step a directory of its
    own with the state file and the step's metrics; a new Trainer on the
    same output path resumes from 'latest' at max_steps and runs nothing:
    its weights, optimizer and loop state are the saved ones."""
    cfg = _cfg(tmp_path / 'out', batch_size=2, latest_every_n_steps=1)
    tr = _trainer(cfg, tree)
    tr.fit(max_steps=2)
    assert tr.global_step == 2
    saved = tr.out_path / 'saved_models'
    assert _steps(saved / 'best') == [2] and _steps(saved / 'latest') == [2]
    assert sorted(os.listdir(saved / 'best' / '2')) == ['metrics.json', 'state.pt']
    with open(saved / 'best' / '2' / 'metrics.json') as f:
        assert np.isfinite(json.load(f)['val_detection_loss'])
    assert not [d for d in os.listdir(saved / 'latest') if not d.isdigit()]   # no temporary
    weights = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
    loop = dict(tr.loop_state)
    tr.close()

    tr2 = _trainer(cfg, tree)
    tr2.fit(max_steps=2)
    assert tr2.global_step == 2 and tr2.state.optimizer.count == 2
    assert tr2.loop_state['batch_in_epoch'] == 0
    assert tr2.loop_state['best_val'] == loop['best_val']
    for k, v in tr2.state.model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    records = [json.loads(line) for line in open(tr2.out_path / 'metrics.jsonl')]
    assert max(r['step'] for r in records if 'train_loss' in r) == 2
    tr2.close()


def test_restore_raises_on_a_missing_path(tree, tmp_path):
    tr = _trainer(_cfg(tmp_path / 'out'), tree)
    tr.init_state(next(iter(tr.loader('val'))))
    with pytest.raises(FileNotFoundError):
        tr.restore(str(tmp_path / 'no_such_ckpt'))
    (tmp_path / 'empty' / '7').mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match='state.pt'):
        tr.restore(str(tmp_path / 'empty'))
    tr.close()


def test_pick_restore_step_by_metric(tmp_path):
    """A 'best' root restores its step of least val_detection_loss (not its
    newest), ties to the newer step; a root without metrics its newest."""
    for step, loss in ((3, 2.0), (6, 1.5), (9, 1.5), (12, 4.0)):
        (tmp_path / 'best' / str(step)).mkdir(parents=True)
        with open(tmp_path / 'best' / str(step) / 'metrics.json', 'w') as f:
            json.dump({'val_detection_loss': loss}, f)
        (tmp_path / 'latest' / str(step)).mkdir(parents=True)
    assert _pick_restore_step(str(tmp_path / 'best'), ['3', '6', '9', '12']) == 9
    assert _pick_restore_step(str(tmp_path / 'latest'), ['3', '6', '9', '12']) == 12


def test_k_dispatch_with_an_odd_tail_lands_on_max_steps(tree, tmp_path):
    """steps_per_dispatch=2 over 4 batches an epoch with max_steps=3: one
    group of two, then the last group cut to one single step."""
    tr = _trainer(_cfg(tmp_path / 'out', steps_per_dispatch=2), tree)
    tr.fit(max_epochs=1, max_steps=3)
    assert tr.global_step == 3 and tr.state.optimizer.count == 3
    assert tr.loop_state['batch_in_epoch'] == 0 and tr.loop_state['epoch'] == 1
    tr.close()


def test_test_pass_writes_one_json_per_frame(tree, tmp_path):
    """test(): one aiMotive JSON for each val frame, in the dataset's tree
    layout under outputs/, the PR curves, and the test metrics."""
    tr = _trainer(_cfg(tmp_path / 'out', batch_size=3), tree)
    tr.init_state(next(iter(tr.loader('val'))))
    metrics = tr.test()
    files = sorted((tr.out_path / 'outputs').rglob('*.json'))
    assert [f.name for f in files] == [f'frame_{i:07d}.json' for i in range(1, 5)]
    assert all('val/highway/seq000/dynamic/box/3d_body' in str(f) for f in files)
    for f in files:
        assert 'CapturedObjects' in json.loads(f.read_text())
    assert (tr.out_path / 'metrics' / 'test' / 'pr_curves.json').is_file()
    assert np.isfinite(metrics['test_detection_loss']) and 'test_ap_auc' in metrics
    tr.close()


def test_runtime_and_sparse_import_trainers_build(tree, tmp_path):
    """What the eval and serving runtime brought (EMA, viz panels, profile,
    predict, BN folding) builds, and predict and folding ask for a state;
    the sparse-import LiDAR encoder (the checkpoint-import slice) builds,
    inits and validates, its masked BNs unfolded by folding."""
    import dataclasses
    cfg = _cfg(tmp_path / 'out')
    for ok in (cfg.replace(viz_every_n_steps=2), cfg.replace(use_ema=True, use_tta=True)):
        Trainer(ok, device='cpu').close()
    tr = Trainer(cfg, device='cpu')
    for call in (tr.predict, tr.fold_bn_for_inference):
        with pytest.raises(RuntimeError, match='init_state'):
            call()
    tr.close()
    sparse = cfg.replace(lidar_conf=dataclasses.replace(cfg.get_lidar_conf(),
                                                        variant='sparse_import'))
    tr = _trainer(sparse, tree)
    state = tr.init_state(next(iter(tr.loader('val'))))
    assert any(k.startswith('lidar_encoder.pts_middle_encoder.') for k in
               state.model.state_dict())
    metrics = tr.validate(max_batches=1)
    assert np.isfinite(metrics['val_detection_loss'])
    tr.fold_bn_for_inference()
    assert np.isfinite(tr.validate(max_batches=1)['val_detection_loss'])
    tr.close()


def _boxes_of(files):
    return {f.name: [(o['ObjectType'], round(o['Score'], 6), round(o['BoundingBox3D Origin X'], 5),
                      round(o['BoundingBox3D Origin Y'], 5))
                     for o in json.loads(f.read_text())['CapturedObjects']] for f in files}


@pytest.mark.parametrize('kw', [dict(), dict(use_ema=True, use_tta=True)], ids=['plain', 'ema_tta'])
def test_predict_exports_the_boxes_of_the_test_pass(tree, tmp_path, kw):
    """predict(): one aiMotive JSON a val frame, the same boxes as the test
    pass exports on the same state (with EMA and TTA: both on the shadow,
    through the flip ensemble)."""
    tr = _trainer(_cfg(tmp_path / 'out', batch_size=3, **kw), tree)
    tr.init_state(next(iter(tr.loader('val'))))
    if kw:
        with torch.no_grad():
            for k, t in tr.state.ema.items():
                if k.endswith('bias'):
                    t.add_(0.05)
    tr.predict()
    out = tr.out_path / 'outputs'
    predicted = _boxes_of(sorted(out.rglob('*.json')))
    for f in out.rglob('*.json'):
        f.unlink()
    tr.test()
    tested = _boxes_of(sorted(out.rglob('*.json')))
    assert sorted(predicted) == [f'frame_{i:07d}.json' for i in range(1, 5)]
    assert predicted == tested and sum(map(len, tested.values())) > 20
    tr.close()


def test_profile_writes_a_trace_that_parses(tree, tmp_path):
    """profile(n): n train steps (wrapping around an epoch of 2 batches)
    traced into profile/trace.json, a Chrome trace that parses; the state
    advanced by n steps."""
    tr = Trainer(_cfg(tmp_path / 'out', batch_size=2), data_root=tree, device='cpu')
    path = tr.profile(n_steps=3)
    assert path == str(tr.out_path / 'profile')
    trace = json.loads((Path(path) / 'trace.json').read_text())
    assert len(trace['traceEvents']) > 100
    assert tr.global_step == tr.state.step == 3
    tr.close()


def test_fit_with_viz_ema_and_tta_writes_panels_and_scenes(tree, tmp_path):
    """fit with viz_every_n_steps=2, use_ema and use_tta: the train panels
    every 2 steps and the first val batch's each epoch (BEV raster,
    heatmaps), each a PNG of the panel's size, and the 3D scenes (.ply and
    boxes JSON); the checkpoints carry the shadow and restore brings it
    back; no viz failure warned."""
    import warnings
    cfg = _cfg(tmp_path / 'out', batch_size=2, viz_every_n_steps=2, use_ema=True, use_tta=True)
    tr = _trainer(cfg, tree)
    with warnings.catch_warnings():
        warnings.simplefilter('error', UserWarning)
        tr.fit(max_steps=4)
    panels = sorted(p.name for p in (tr.out_path / 'panels').iterdir())
    assert panels == sorted(f'{split}_{kind}_{step:07d}.png' for split in ('train', 'val')
                            for kind in ('bev', 'heatmaps') for step in (2, 4))
    png = (tr.out_path / 'panels' / 'val_bev_0000004.png').read_bytes()
    pc = cfg.point_cloud_range
    assert png[:8] == b'\x89PNG\r\n\x1a\n'
    assert int.from_bytes(png[16:20], 'big') == round((pc[3] - pc[0]) * 2)
    assert int.from_bytes(png[20:24], 'big') == round((pc[4] - pc[1]) * 2)
    scenes = sorted(p.name for p in (tr.out_path / 'scenes').iterdir())
    assert 'train_scene_0000002.ply' in scenes and 'val_scene_0000004_boxes.json' in scenes
    ema = {k: v.clone() for k, v in tr.state.ema.items()}
    assert any(not torch.equal(ema[k], v) for k, v in tr.state.model.state_dict().items())
    tr.close()
    tr2 = _trainer(cfg.replace(out_path=str(tmp_path / 'out2')), tree)
    tr2.init_state(next(iter(tr2.loader('val'))))
    tr2.restore(str(tr.out_path / 'saved_models' / 'latest'))
    for k, v in ema.items():
        assert torch.equal(tr2.state.ema[k], v), k
    tr2.close()


# ------------------------------------------------------------- slow tier

@pytest.fixture(scope='module')
def two_odd_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('aim_e2e'))
    generate_synthetic_dataset(root, splits=('train', 'val'), odds=('highway', 'urban'),
                               frames_per_sequence=2, write_images=False)
    return root


@pytest.mark.slow
def test_fit_multi_dispatch_validate_and_artifacts(two_odd_tree, tmp_path):
    """test_trainer_e2e.py's counterpart: two epochs with K=2 groups, the
    periodic 'latest' across group boundaries, validation with BEV mAP, the
    test pass's export and PR curves, the config snapshot, a resume."""
    cfg = _cfg(tmp_path / 'out', steps_per_dispatch=2)
    tr = _trainer(cfg, two_odd_tree)
    tr.fit(max_epochs=2)
    assert tr.global_step == 8     # 2 odds x 2 frames = 4 batches an epoch
    assert (tr.out_path / 'saved_models' / 'latest').is_dir()
    val = tr.validate(max_batches=4)
    assert np.isfinite(val['val_detection_loss']) and 'val_ap_auc' in val
    tr.test(max_batches=2)
    assert list((tr.out_path / 'outputs').rglob('*.json'))
    assert (tr.out_path / 'metrics' / 'test' / 'pr_curves.json').stat().st_size > 0
    assert (tr.out_path / 'config.json').is_file()
    tr.close()
    tr2 = _trainer(cfg, two_odd_tree)
    tr2.init_state(next(iter(tr2.loader('train'))))
    tr2.restore(str(tr.out_path / 'saved_models' / 'latest'))
    assert tr2.global_step == 8
    tr2.close()


@pytest.mark.slow
def test_partial_dispatch_group_falls_back_to_single_steps(two_odd_tree, tmp_path):
    for k, max_steps, want in ((3, None, 4), (8, None, 4), (3, 2, 2)):
        tr = _trainer(_cfg(tmp_path / f'o{k}{max_steps}', steps_per_dispatch=k), two_odd_tree)
        tr.fit(max_epochs=1, max_steps=max_steps)
        assert tr.global_step == want
        tr.close()


@pytest.mark.slow
def test_per_odd_eval_matrix(two_odd_tree, tmp_path):
    tr = _trainer(_cfg(tmp_path / 'out'), two_odd_tree)
    tr.init_state(next(iter(tr.loader('val'))))
    res = tr.test_all_odds(odds=('highway', 'urban', 'night'), max_batches=1)
    assert set(res) == {'highway', 'urban'}
    for odd, metrics in res.items():
        assert f'test_{odd}_detection_loss' in metrics
    tr.close()


def _launch(root, out, max_steps, res):
    return subprocess.Popen([sys.executable, __file__, root, out, str(max_steps), res],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


@pytest.mark.slow
def test_sigkill_mid_run_then_auto_resume(tmp_path):
    """test_preemption.py's counterpart: SIGKILL a training process once a
    'latest' step >= 2 is on disk (mid-step, possibly mid-write), relaunch
    on the same output path: it resumes from a whole step and ends where an
    unkilled control run ends, with the same loop state and best steps."""
    root = generate_synthetic_dataset(str(tmp_path / 'ds'), splits=('train', 'val'),
                                      frames_per_sequence=5, n_objects=4, write_images=False)
    out, res = str(tmp_path / 'out'), str(tmp_path / 'result.json')
    latest = Path(out) / 'saved_models' / 'latest'
    ctl_res = str(tmp_path / 'ctl_result.json')
    ctl = _launch(root, str(tmp_path / 'ctl_out'), 8, ctl_res)
    p = _launch(root, out, 8, res)
    deadline = time.time() + 600
    try:
        while time.time() < deadline:
            if latest.is_dir() and _steps(latest) and _steps(latest)[-1] >= 2:
                break
            if p.poll() is not None:
                break
            time.sleep(0.1)
        else:
            pytest.fail('no committed checkpoint for step >= 2 within 600 s')
        assert p.poll() is None, 'the worker finished before the kill: raise max_steps'
    finally:
        p.kill()
        p.communicate()
    killed_at = _steps(latest)[-1]
    assert not os.path.exists(res)
    assert not [d for d in os.listdir(latest) if not d.isdigit() and not d.startswith('.')]
    p2 = _launch(root, out, 8, res)
    log = p2.communicate(timeout=600)[0].decode()
    assert p2.returncode == 0, log[-3000:]
    with open(res) as f:
        r = json.load(f)
    assert r['resumed_from'] >= killed_at and r['final_step'] == 8, (r, killed_at)
    logged = [json.loads(line)['step'] for line in open(Path(out) / 'metrics.jsonl')
              if 'train_loss' in line]
    assert logged[-1] == 8 and logged.count(1) == 1
    assert ctl.communicate(timeout=600)[0] is not None and ctl.returncode == 0
    with open(ctl_res) as f:
        c = json.load(f)
    assert c['final_step'] == 8
    assert r['loop_state'] == c['loop_state'] and r['best_steps'] == c['best_steps'], (r, c)


def _preempt_worker(root, out, max_steps, res):
    cfg = _cfg(out, num_workers=1, latest_every_n_steps=1, max_epochs=50)
    tr = _trainer(cfg, root)
    tr.init_state(next(iter(tr.loader('train'))))
    resumed_from = 0
    latest = tr.out_path / 'saved_models' / 'latest'
    if latest.is_dir():
        tr.restore(str(latest))
        resumed_from = tr.global_step
    print(f'RESUMED_FROM {resumed_from}', flush=True)
    tr.fit(max_steps=int(max_steps))
    best = tr.out_path / 'saved_models' / 'best'
    with open(res, 'w') as f:
        json.dump({'resumed_from': resumed_from, 'final_step': tr.global_step,
                   'loop_state': tr.loop_state,
                   'best_steps': _steps(best) if best.is_dir() else []}, f)
    tr.close()


if __name__ == '__main__':
    _preempt_worker(*sys.argv[1:5])
