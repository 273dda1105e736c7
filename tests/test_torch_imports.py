"""The port stands alone: no jax, flax or mm_training_tpu import anywhere in
``mm_training_tpu_torch`` or ``chip_smoke.py``; and its entry points refuse
to fall back to the CPU when no device is named and there is no card."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mm_training_tpu_torch.configs import tiny_test_config
from mm_training_tpu_torch.exps import inference, profile_convs, profile_kernels, profile_train
from mm_training_tpu_torch.models import BEVDepthLiDAR

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
for name in ('mm_training_tpu_torch.ops.gaussian', 'mm_training_tpu_torch.training.optim',
             'mm_training_tpu_torch.exps.profile_train', 'mm_training_tpu_torch.core.geometry',
             'mm_training_tpu_torch.ops.voxel_pooling', 'mm_training_tpu_torch.ops.deform_conv',
             'mm_training_tpu_torch.ops.depth_labels', 'mm_training_tpu_torch.ops.warp',
             'mm_training_tpu_torch.models.depth_net', 'mm_training_tpu_torch.models.lss_fpn',
             'mm_training_tpu_torch.models.fusion',
             'mm_training_tpu_torch.exps.profile_convs',
             'mm_training_tpu_torch.utils.universal', 'mm_training_tpu_torch.utils.logging',
             'mm_training_tpu_torch.utils.profiling', 'mm_training_tpu_torch.evaluation.bev_map',
             'mm_training_tpu_torch.core.transforms', 'mm_training_tpu_torch.core.boxes',
             'mm_training_tpu_torch.data.formats', 'mm_training_tpu_torch.data.lasio',
             'mm_training_tpu_torch.data.native', 'mm_training_tpu_torch.data.loaders',
             'mm_training_tpu_torch.data.image',
             'mm_training_tpu_torch.data.sensor_models.cameras',
             'mm_training_tpu_torch.data.frame_loader',
             'mm_training_tpu_torch.data.aimotive_dataset', 'mm_training_tpu_torch.data.synthetic',
             'mm_training_tpu_torch.training.loader', 'mm_training_tpu_torch.training.trainer',
             'mm_training_tpu_torch.exps.common', 'mm_training_tpu_torch.exps.train',
             'mm_training_tpu_torch.exps.evaluate'):
    assert importlib.util.find_spec(name) is not None, name
for banned in ('jax', 'flax', 'mm_training_tpu'):
    sys.modules[banned] = None        # any import of them raises ImportError
import mm_training_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mm_training_tpu_torch.__path__,
                                                'mm_training_tpu_torch.')]
for n in names:
    importlib.import_module(n)
import chip_smoke
leaked = [m for m, v in sys.modules.items() if v is not None
          and m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mm_training_tpu')]
assert not leaked, leaked
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # every module of the package, the camera and runtime slices' included
    assert int(out.stdout.split()[-1]) >= 61


_NO_IMAGE_CODEC = '''
import sys
for banned in ('cv2', 'PIL'):
    sys.modules[banned] = None        # any import of them raises ImportError
import mm_training_tpu_torch.data, mm_training_tpu_torch.training.trainer
import mm_training_tpu_torch.exps.train, mm_training_tpu_torch.exps.evaluate
'''


def test_lidar_data_path_imports_no_image_codec():
    """The data path (its JPEG decode and image ops are the port's own), the
    trainer and its CLIs import neither cv2 nor PIL (the card's machine
    promises neither)."""
    out = subprocess.run([sys.executable, '-c', _NO_IMAGE_CODEC], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        BEVDepthLiDAR(tiny_test_config())
    with pytest.raises(RuntimeError, match='no CUDA device'):
        BEVDepthLiDAR(tiny_test_config(use_cam=True))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        inference.main(['--latency', '--config', 'lidar_cam_radar', '--iters', '1'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        inference.main(['--latency', '--config', 'tiny_test_config', '--iters', '1'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        profile_train.main(['--steps', '1'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        profile_kernels.main()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        profile_convs.main([])


@pytest.mark.parametrize('camera', [False, True])
def test_latency_cli_on_cpu_when_asked(capsys, camera):
    stats = inference.main(['--latency', '--config', 'tiny_test_config', '--iters', '2',
                            '--device', 'cpu'] + ['use_cam=True'] * camera)
    assert stats['batch_size'] == 1 and stats['p50_ms'] > 0
    assert 'p50_ms=' in capsys.readouterr().out
