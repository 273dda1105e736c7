"""The port's ``Trainer.setup`` ``steps_per_epoch`` default against the JAX
trainer's, as ``tests/test_training/test_setup_fallback.py`` holds the JAX
one. The LR milestones are scheduled in steps, so a wrong default corrupts
the schedule silently: a dataset without ``__len__`` falls back to 1000
with a loud UserWarning, any other loader failure propagates, and an
explicit value never touches the loader. Each case runs both trainers'
``setup`` on the same injected dataset (no step is compiled)."""
import warnings

import pytest

import mm_training_tpu.configs as jcfg
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu.training.trainer import Trainer as JTrainer
from mm_training_tpu_torch.training.trainer import Trainer


class _NoLenDataset:
    """An iterable-style dataset a user might inject through ``datasets``."""

    def __getitem__(self, i):   # pragma: no cover - never reached in setup
        raise IndexError


class _BrokenDataset:
    def __len__(self):
        raise ValueError('corrupt index file')


def _trainers(tmp_path, dataset):
    """(the port's trainer on the CPU, the JAX trainer), each on ``dataset``
    with its own output directory."""
    kw = dict(use_cam=False, use_radar=False)
    port = Trainer(tcfg.tiny_test_config(out_path=str(tmp_path / 'port'), **kw),
                   datasets={'train': dataset}, device='cpu')
    ref = JTrainer(jcfg.tiny_test_config(out_path=str(tmp_path / 'jax'), **kw),
                   datasets={'train': dataset})
    return port, ref


def test_no_len_dataset_warns_and_defaults(tmp_path):
    port, ref = _trainers(tmp_path, _NoLenDataset())
    messages = []
    for tr in (port, ref):
        with pytest.warns(UserWarning, match='no __len__') as rec:
            tr.setup()
        messages.append([str(w.message) for w in rec if issubclass(w.category, UserWarning)
                         and 'no __len__' in str(w.message)])
    assert port.steps_per_epoch == ref.steps_per_epoch == 1000
    assert messages[0] == messages[1]
    port.close()


def test_broken_loader_propagates(tmp_path):
    port, ref = _trainers(tmp_path, _BrokenDataset())
    for tr in (port, ref):
        with pytest.raises(ValueError, match='corrupt index file'):
            tr.setup()
    assert not hasattr(port, 'steps_per_epoch')
    port.close()


def test_explicit_steps_per_epoch_skips_loader(tmp_path):
    """An explicit value does not touch the (broken) loader at all."""
    port, ref = _trainers(tmp_path, _BrokenDataset())
    for tr in (port, ref):
        with warnings.catch_warnings():
            warnings.simplefilter('error', UserWarning)
            tr.setup(steps_per_epoch=250)
    assert port.steps_per_epoch == ref.steps_per_epoch == 250
    assert (tmp_path / 'port' / 'config.json').is_file()
    port.close()
