"""The port's CLI plumbing (``exps/common.py``, ``exps/train.py``,
``exps/evaluate.py``): the counterparts of the fast cases of
``tests/test_training/test_cli.py``, and the field diff of the two
packages' ``Config``."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import mm_training_tpu.configs as jcfg
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu_torch.data import generate_synthetic_dataset
from mm_training_tpu_torch.exps import inference, train
from mm_training_tpu_torch.exps.common import build_config, parse_args

# the JAX Config's fields the port has not taken yet, each with the module
# that will read it; a field added to either Config shows in the diff below.
# None: model_parallel and num_slices lay out the ranks (parallel/mesh.py)
NOT_YET_PORTED = set()


def test_config_fields_match_jax_but_the_listed_ones():
    """Every field of the JAX Config is in the port's, with its default,
    except NOT_YET_PORTED; the port has no field of its own."""
    jf = {f.name: f for f in dataclasses.fields(jcfg.Config)}
    tf = {f.name: f for f in dataclasses.fields(tcfg.Config)}
    assert set(jf) - set(tf) == NOT_YET_PORTED
    assert set(tf) - set(jf) == set()
    assert dataclasses.asdict(tcfg.Config()) == {
        k: v for k, v in dataclasses.asdict(jcfg.Config()).items() if k not in NOT_YET_PORTED}
    assert tcfg.CLASSES == jcfg.CLASSES and tcfg.CATEGORY_MAPPING == jcfg.CATEGORY_MAPPING
    for variant in ('eval_lidar_only', 'eval_lidar_radar'):
        assert (dataclasses.asdict(getattr(tcfg, variant)(ckpt_path='x'))
                == {k: v for k, v in dataclasses.asdict(getattr(jcfg, variant)(
                    ckpt_path='x')).items() if k not in NOT_YET_PORTED})


# fields of the JAX sub-configs the port has not taken: none
# (``aspp_mid_channels``, which nothing in either package reads, is taken)
SUB_NOT_YET_PORTED = {}


@pytest.mark.parametrize('name', ['ImageBackboneConf', 'ImageNeckConf', 'DepthNetConf',
                                  'BackboneConf', 'VoxelizationConf', 'LidarEncoderConf'])
def test_sub_config_fields_match_jax(name):
    """Each sub-config of the camera and LiDAR branches has the JAX one's
    fields and defaults (``ImageBackboneConf.pretrained`` and
    ``LidarEncoderConf.variant='sparse_import'`` among them), but the
    listed ones."""
    jf = {f.name: f for f in dataclasses.fields(getattr(jcfg, name))}
    tf = {f.name: f for f in dataclasses.fields(getattr(tcfg, name))}
    assert set(jf) - set(tf) == SUB_NOT_YET_PORTED.get(name, set()) and set(tf) <= set(jf)
    skip = set().union(*SUB_NOT_YET_PORTED.values())

    def ported(d):     # nested sub-configs too (BackboneConf holds a DepthNetConf)
        return {k: ported(v) if isinstance(v, dict) else v for k, v in d.items()
                if k not in skip}
    assert (ported(dataclasses.asdict(getattr(tcfg, name)()))
            == ported(dataclasses.asdict(getattr(jcfg, name)())))


def test_variant_and_overrides():
    args = parse_args(['--config', 'lidar_cam_radar', '--seed', '7', 'batch_size=2',
                       'steps_per_dispatch=3', 'data_root=/data/x', 'base_learning_rate=1e-4'])
    cfg = build_config(args)
    assert cfg.use_cam and cfg.use_lidar and cfg.use_radar
    assert cfg.batch_size == 2 and cfg.seed == 7 and cfg.steps_per_dispatch == 3
    assert cfg.data_root == '/data/x'
    assert cfg.base_learning_rate == pytest.approx(1e-4)


@pytest.mark.parametrize('argv', [['--config', 'nope'], ['--config', 'lidar_only', 'oops'],
                                  ['--config', 'lidar_only', 'model_parallel=0']])
def test_bad_variant_or_override_errors(argv):
    """An unknown variant, an override without '=', and a value the port's
    Config refuses (``model_parallel`` under 1) exit."""
    with pytest.raises(SystemExit):
        build_config(parse_args(argv))


@pytest.mark.parametrize('knob', ['model_parallel', 'num_slices'])
def test_tpu_mesh_knobs_raise_naming_the_knob(knob):
    """``model_parallel`` and ``num_slices`` take the JAX default 1 and any
    count of at least 1, from the Config and through the CLI; a count under
    1 raises, naming the knob."""
    assert getattr(tcfg.Config(), knob) == 1
    assert getattr(tcfg.lidar_radar(**{knob: 2}), knob) == 2
    assert getattr(build_config(parse_args(['--config', 'lidar_only', f'{knob}=2'])), knob) == 2
    with pytest.raises(ValueError, match=f'{knob}=0: the rank layout takes a count'):
        tcfg.lidar_radar(**{knob: 0})
    with pytest.raises(SystemExit, match=knob):
        build_config(parse_args(['--config', 'lidar_only', f'{knob}=0']))


@pytest.mark.parametrize('knob', ['model_parallel', 'num_slices'])
def test_mesh_knobs_reach_the_trainer_layout(knob, tmp_path):
    """A knob of 2 from the CLI reaches the trainer's layout: in a world of
    4 ranks (rank 1, faked: no subgroup is made) two rows or two slices;
    in one process, a world the knob does not divide, it raises naming the
    knob."""
    from unittest import mock

    import torch

    from mm_training_tpu_torch import parallel
    from mm_training_tpu_torch.training.trainer import Trainer
    cfg = build_config(parse_args(['--config', 'tiny_test_config', f'{knob}=2',
                                   f'out_path={str(tmp_path)!r}']))
    try:
        with mock.patch.object(parallel.mesh, 'process_count', lambda: 4), \
                mock.patch.object(parallel.mesh, 'process_index', lambda: 1), \
                mock.patch.object(torch.distributed, 'is_initialized', lambda: False):
            tr = Trainer(cfg, device='cpu')
            want = (np.arange(4).reshape(2, 2) if knob == 'model_parallel'
                    else np.arange(4)[None])
            np.testing.assert_array_equal(tr.mesh.layout, want)
            assert tr.data_parallel_size == want.shape[1]
            tr.close()
        with pytest.raises(ValueError, match=f'{knob}=2'):
            Trainer(cfg, device='cpu')
    finally:
        parallel.reset_mesh()


def test_extra_flags_and_device():
    args = parse_args(['--config', 'lidar_only', '--latency'], extra_flags=('latency',))
    assert args.latency is True and args.device is None
    args = parse_args(['--config', 'lidar_only', '--device', 'cpu'], extra_flags=('latency',))
    assert args.latency is False and args.device == 'cpu'


def test_string_values_pass_through():
    cfg = build_config(parse_args(['--config', 'eval_lidar_radar', 'eval_split=night']))
    assert cfg.eval_split == 'night' and cfg.experiment_name == 'lidar_radar_eval'
    cfg = build_config(parse_args(['--config', 'eval_lidar_radar', 'eval_split=None',
                                   '--max-epochs', '3']))
    assert cfg.eval_split is None and cfg.max_epochs == 3


def _lidar_tree(root):
    generate_synthetic_dataset(str(root), splits=('train', 'val'), frames_per_sequence=2,
                               n_objects=4, write_images=False, lidar_format='laz',
                               n_ground_points=800)
    return str(root)


def test_train_profile_flag_raises_until_ported(tmp_path):
    """--profile (Trainer.profile, now ported) traces a few train steps
    into <out_path>/profile/trace.json, a Chrome trace that parses, and
    exits with {} (the JAX CLI's contract,
    tests/test_training/test_cli.py::test_train_profile_flag)."""
    root = _lidar_tree(tmp_path / 'ds')
    out = train.main(['--config', 'tiny_test_config', '--profile', '--device', 'cpu',
                      '--max-steps', '1', '--data-root', root, 'use_cam=False', 'batch_size=1',
                      'num_workers=1', f'out_path={str(tmp_path / "out")!r}'])
    assert out == {}
    trace = json.loads((tmp_path / 'out' / 'profile' / 'trace.json').read_text())
    assert trace['traceEvents']


def _boxes(out_dir):
    files = sorted(Path(out_dir).rglob('*.json'))
    return files, [[(o['ObjectType'], o['Score'], o['BoundingBox3D Origin X'])
                    for o in json.loads(f.read_text())['CapturedObjects']] for f in files]


def test_inference_exports_with_and_without_fold_bn(tmp_path):
    """exps.inference's export mode on a checkpoint exps.train wrote: one
    aiMotive JSON a val frame; with --fold-bn (fp32) the same boxes within
    2e-3 and the same labels; --latency --fold-bn serves folded weights."""
    root = _lidar_tree(tmp_path / 'ds')
    common = ['--config', 'tiny_test_config', '--device', 'cpu', '--data-root', root,
              'use_cam=False', 'batch_size=1', 'num_workers=1', 'precision="fp32"']
    train.main(['--max-steps', '1'] + common + ['num_sanity_val_steps=0',
                                                f'out_path={str(tmp_path / "train")!r}'])
    best = str(tmp_path / 'train' / 'saved_models' / 'best')
    got = {}
    for flag in ([], ['--fold-bn']):
        out = inference.main(flag + common + [f'ckpt_path={best!r}',
                                              f'out_path={str(tmp_path / str(len(flag)))!r}'])
        assert out == str(tmp_path / str(len(flag)) / 'outputs')
        got[bool(flag)] = _boxes(out)
    (files, plain), (folded_files, folded) = got[False], got[True]
    assert [f.name for f in files] == [f.name for f in folded_files] == [
        'frame_0000001.json', 'frame_0000002.json']
    assert sum(map(len, plain)) > 20
    for a, b in zip(plain, folded):
        assert [o[0] for o in a] == [o[0] for o in b]
        np.testing.assert_allclose([o[1:] for o in a], [o[1:] for o in b], atol=2e-3)
    stats = inference.main(['--latency', '--fold-bn', '--config', 'tiny_test_config',
                            '--iters', '1', '--device', 'cpu'])
    assert stats['p50_ms'] > 0


@pytest.mark.slow
def test_inference_fold_bn_matches_unfolded(tmp_path):
    """The port's counterpart of the JAX CLI test: Trainer.
    fold_bn_for_inference (the --fold-bn path) predicts the boxes of the
    unfolded predict on the same weights (boxes and scores within 2e-3,
    labels and valid equal; fp32), and folding one Trainer leaves another
    Trainer in the process unfolded."""
    from mm_training_tpu_torch.models.bn_fold import BatchNorm2d, FoldedBN
    from mm_training_tpu_torch.training.trainer import Trainer
    root = _lidar_tree(tmp_path / 'ds')
    cfg = tcfg.tiny_test_config(use_cam=False, use_lidar=True, use_radar=True, batch_size=1,
                                num_workers=1, precision='fp32', out_path=str(tmp_path / 'out'))
    tr = Trainer(cfg, data_root=root, device='cpu')
    tr.setup(steps_per_epoch=1)
    batch = next(iter(tr.loader('val')))
    tr.init_state(batch)
    _, device_batch, _ = next(iter(tr._device_batches(tr.loader('val'))))
    unfolded = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
    ref = [t.numpy() for t in tr._predict_step(tr.state, device_batch)]
    tr.fold_bn_for_inference()
    got = [t.numpy() for t in tr._predict_step(tr.state, device_batch)]
    np.testing.assert_array_equal(ref[3], got[3])
    assert ref[3].sum() > 50
    for b, i in zip(*np.nonzero(ref[3])):
        # near-tied scores of a random init trade slots, and at a task's
        # top-k cut (83 slots) a box may be kept on one side only: match by
        # label and score
        block = slice(i // 83 * 83, (i // 83 + 1) * 83)
        cut = ref[1][b, block][ref[3][b, block]].min()
        same = got[3][b] & (got[2][b] == ref[2][b, i]) & (np.abs(got[1][b] - ref[1][b, i]) <= 2e-3)
        err = np.abs(got[0][b, same] - ref[0][b, i]).max(-1).min() if same.any() else np.inf
        assert err <= 2e-3 or ref[1][b, i] - cut <= 2e-3, (b, i)
    tr2 = Trainer(cfg.replace(out_path=str(tmp_path / 'out2')), data_root=root, device='cpu')
    tr2.setup(steps_per_epoch=1)
    tr2.init_state(batch)
    tr2.state.model.load_state_dict(unfolded)
    assert not any(isinstance(m, FoldedBN) for m in tr2.state.model.modules())
    assert any(isinstance(m, BatchNorm2d) for m in tr2.state.model.modules())
    got2 = [t.numpy() for t in tr2._predict_step(tr2.state, device_batch)]
    for a, b in zip(ref, got2):
        np.testing.assert_array_equal(a, b)
    tr.close()
    tr2.close()
