"""The port's CLI plumbing (``exps/common.py``, ``exps/train.py``,
``exps/evaluate.py``): the counterparts of the fast cases of
``tests/test_training/test_cli.py``, and the field diff of the two
packages' ``Config``."""
import dataclasses

import pytest

import mm_training_tpu.configs as jcfg
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu_torch.exps import train
from mm_training_tpu_torch.exps.common import build_config, parse_args

# the JAX Config's fields the port has not taken yet, each with the module
# that will read it; a field added to either Config shows in the diff below
NOT_YET_PORTED = {
    'depth_gt_root',          # the camera data slice (precomputed depth labels)
    'virtualize_fisheyes',    # the camera data slice
    'ema_decay',              # EMA (training/ema.py)
    'use_tta',                # TTA (training/tta.py)
    'model_parallel',         # the TPU mesh; DDP replaces data parallelism
    'num_slices',             # the TPU mesh
}


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


def test_variant_and_overrides():
    args = parse_args(['--config', 'lidar_cam_radar', '--seed', '7', 'batch_size=2',
                       'steps_per_dispatch=3', 'data_root=/data/x', 'base_learning_rate=1e-4'])
    cfg = build_config(args)
    assert cfg.use_cam and cfg.use_lidar and cfg.use_radar
    assert cfg.batch_size == 2 and cfg.seed == 7 and cfg.steps_per_dispatch == 3
    assert cfg.data_root == '/data/x'
    assert cfg.base_learning_rate == pytest.approx(1e-4)


@pytest.mark.parametrize('argv', [['--config', 'nope'], ['--config', 'lidar_only', 'oops'],
                                  ['--config', 'lidar_only', 'use_tta=True']])
def test_bad_variant_or_override_errors(argv):
    """An unknown variant, an override without '=', and a field the port's
    Config does not have yet (the JAX CLI takes ``use_tta``) exit."""
    with pytest.raises(SystemExit):
        build_config(parse_args(argv))


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


def test_train_profile_flag_raises_until_ported(tmp_path):
    """--profile needs Trainer.profile, which a later part of the runtime
    slice brings."""
    with pytest.raises(NotImplementedError, match='Trainer.profile'):
        train.main(['--config', 'tiny_test_config', '--profile', '--device', 'cpu',
                    f'out_path={str(tmp_path)!r}'])
