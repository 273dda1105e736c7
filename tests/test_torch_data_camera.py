"""The port's camera data path against the JAX package's (which reads,
re-renders and augments images with cv2): every array of every sample and
of the collated batch byte-equal for ``tiny_test_config(use_cam=True)``,
the train split (augmented) at two epochs and the val split, with the
fisheyes virtualized (``num_cameras=6``), camera-only (the field-of-view
filter) and with ``depth_gt_root`` grids written by the JAX package's
``scripts/gen_depth_gt.py``; ``augment_image_np`` draw for draw; the
errors of a missing image, a missing grid, too few grids and (the port's
refusal where the JAX trainer fails on the shapes) more grids than the
frame has cameras; the port's writer read back by both; the loader's
threads; and the camera path without cv2 or PIL importable. Trees are
written by the JAX writer unless a test says otherwise."""
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

import mm_training_tpu.configs as jcfg
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu.data import AiMotiveDataset as JDataset
from mm_training_tpu.data import collate_aim as j_collate
from mm_training_tpu.data.aimotive_dataset import augment_image_np as j_augment
from mm_training_tpu.data.synthetic import generate_synthetic_dataset as j_generate
from mm_training_tpu.scripts import gen_depth_gt
from mm_training_tpu_torch.core.geometry import rig_is_row_independent
from mm_training_tpu_torch.data import AiMotiveDataset, collate_aim, generate_synthetic_dataset
from mm_training_tpu_torch.data.aimotive_dataset import augment_image_np
from mm_training_tpu_torch.data.frame_loader import FrameLoader
from mm_training_tpu_torch.training.loader import PrefetchLoader

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = {
    'lidar_cam_radar': dict(),
    'fisheyes': dict(virtualize_fisheyes=True, num_cameras=6),
    'cam_only': dict(use_lidar=False, use_radar=False),
}


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('aim_cam'))
    j_generate(root, splits=('train', 'val'), frames_per_sequence=3, n_objects=8,
               img_hw=(64, 128), fisheyes=True, image_detail=True, lidar_format='laz',
               n_ground_points=2000, seed=5)
    return root


@pytest.fixture(scope='module')
def grids(tree, tmp_path_factory):
    """{fisheyes: root of the JAX package's depth-GT mirror tree}."""
    out = {}
    for fish in (False, True):
        root = str(tmp_path_factory.mktemp(f'depth_gt_{fish}'))
        for split in ('train', 'val'):
            gen_depth_gt.main(['--data-root', tree, '--split', split, '--out', root,
                               '--workers', '1', '--height', '64', '--width', '128']
                              + ['--virtualize-fisheyes'] * fish)
        out[fish] = root
    return out


def _assert_same(a, b):
    assert list(a) == list(b)
    for k in a:
        if k == 'path':
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


def _check_equal(root, jc, tc, epochs=(0, 1)):
    for split, eps in (('train', epochs), ('val', (0,))):
        jd, td = JDataset(root, jc, split), AiMotiveDataset(root, tc, split)
        assert td.dataset_index == jd.dataset_index and len(td) == 3
        for epoch in eps:
            jd.set_epoch(epoch)
            td.set_epoch(epoch)
            js = [jd[i] for i in range(len(jd))]
            ts = [td[i] for i in range(len(td))]
            for a, b in zip(js, ts):
                _assert_same(a, b)
            _assert_same(j_collate(js), collate_aim(ts))
    return ts


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_camera_batches_equal_jax(tree, variant):
    kw = VARIANTS[variant]
    ts = _check_equal(tree, jcfg.tiny_test_config(use_cam=True, seed=3, **kw),
                      tcfg.tiny_test_config(use_cam=True, seed=3, **kw))
    n = kw.get('num_cameras', 2)
    assert ts[0]['imgs'].shape == (1, n, 64, 128, 3)
    assert ts[0]['sensor2ego'].shape == (1, n, 4, 4)
    assert 0 < ts[0]['imgs'].mean() < 255
    # virtual pinholes have no roll, pitch or skew: the trainer's raw-rig
    # switch (Trainer.init_state) keeps the factorized splat on them
    batch = collate_aim(ts)
    assert rig_is_row_independent(batch['sensor2ego'], batch['intrin'])


@pytest.mark.parametrize('fish', [False, True])
def test_depth_gt_batches_equal_jax(tree, grids, fish):
    """With depth_gt_root on the JAX package's grids, 'depth_gt' rides along
    as the JAX dataset ships it."""
    kw = dict(VARIANTS['fisheyes'] if fish else {}, depth_gt_root=grids[fish], seed=4)
    ts = _check_equal(tree, jcfg.tiny_test_config(use_cam=True, **kw),
                      tcfg.tiny_test_config(use_cam=True, **kw), epochs=(0,))
    assert ts[0]['depth_gt'].shape == (6 if fish else 2, 4, 8)
    assert ts[0]['depth_gt'].max() > 0


def test_depth_gt_errors(tree, grids, tmp_path):
    """A missing grid file raises FileNotFoundError and too few grids
    ValueError, as in the JAX package; grids that outnumber the frame's
    cameras (num_cameras=4 on grids of the virtualized fisheyes, fisheyes
    off) raise ValueError naming num_cameras in the port, where the JAX
    dataset ships them and its train step fails on the shapes."""
    def both(**kw):
        return (JDataset(tree, jcfg.tiny_test_config(use_cam=True, **kw), 'val'),
                AiMotiveDataset(tree, tcfg.tiny_test_config(use_cam=True, **kw), 'val'))
    for ds in both(depth_gt_root=str(tmp_path / 'nowhere')):
        with pytest.raises(FileNotFoundError, match='depth_gt_root is set'):
            ds[0]
    for ds in both(depth_gt_root=grids[False], **VARIANTS['fisheyes']):
        with pytest.raises(ValueError, match='holds 2 camera grids but the config uses 6'):
            ds[0]
    jd, td = both(depth_gt_root=grids[True], num_cameras=4)
    assert jd[0]['depth_gt'].shape[0] == 4 and jd[0]['imgs'].shape[1] == 2
    with pytest.raises(ValueError, match='4 depth grids .*num_cameras=4.* 2 cameras'):
        td[0]


def test_augment_image_equals_jax(monkeypatch):
    """Draw for draw: the same generator gives the same image and leaves
    the generator in the same state, over seeds that take each branch (the
    HSV jitter, brightness/contrast, dropout) and none."""
    from mm_training_tpu_torch.data import aimotive_dataset
    calls = {'hsv_to_bgr': 0, 'lut': 0}

    def counted(name):
        fn = getattr(aimotive_dataset.image, name)

        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper
    for name in calls:
        monkeypatch.setattr(aimotive_dataset.image, name, counted(name))
    img = np.random.default_rng(0).integers(1, 256, (64, 128, 3), dtype=np.uint8)
    unchanged = dropout = 0
    for seed in range(24):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        want, got = j_augment(img, jr), augment_image_np(img, tr)
        assert got.tobytes() == want.tobytes(), seed
        assert tr.bit_generator.state == jr.bit_generator.state, seed
        assert got is not img
        unchanged += np.array_equal(got, img)
        dropout += int((got == 0).all(-1).sum() >= 64)
    assert calls['hsv_to_bgr'] and calls['lut'] > calls['hsv_to_bgr']
    assert unchanged and dropout


def test_missing_images_raise(tmp_path):
    """A missing front or back image, or a missing fisheye with
    virtualize_fisheyes on, raises FileNotFoundError naming it."""
    root = str(tmp_path)
    generate_synthetic_dataset(root, splits=('val',), frames_per_sequence=1, n_objects=2,
                               img_hw=(32, 64), fisheyes=True, n_ground_points=200)
    seq = os.path.join(root, 'val', 'highway', 'seq000')
    frame = os.path.join(seq, 'dynamic', 'box', '3d_body', 'frame_0000001.json')
    cam = os.path.join(seq, 'sensor', 'camera')
    fl = FrameLoader('val', tcfg.tiny_test_config().point_cloud_range, virtualize_fisheyes=True,
                     image_size=(32, 64))
    assert len(fl[frame].cameras) == 6
    os.remove(os.path.join(cam, 'M_FISHEYE_R', 'M_FISHEYE_R_0000001.jpg'))
    with pytest.raises(FileNotFoundError, match='virtualize_fisheyes is on but .*M_FISHEYE_R'):
        fl[frame]
    fl.virtualize_fisheyes = False
    assert len(fl[frame].cameras) == 2
    os.remove(os.path.join(cam, 'B_MIDRANGECAM_C', 'B_MIDRANGECAM_C_0000001.jpg'))
    with pytest.raises(FileNotFoundError, match='missing or unreadable camera image .*B_MID'):
        fl[frame]


def test_port_writer_tree_reads_the_same(tmp_path):
    """The port's writer (its own encoder, fisheyes on): cv2.imread and the
    port read its JPEGs to the same bytes, and the JAX dataset (cv2) and the
    port's give the same camera batches on its tree."""
    root = str(tmp_path)
    generate_synthetic_dataset(root, splits=('train', 'val'), frames_per_sequence=3,
                               n_objects=6, img_hw=(64, 128), fisheyes=True,
                               image_detail=True, n_ground_points=1500, seed=9)
    from mm_training_tpu_torch.data import image
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith('.jpg')]
    assert len(files) == 24
    for f in files:
        assert image.imread(f).tobytes() == cv2.imread(f).tobytes()
    kw = VARIANTS['fisheyes']
    _check_equal(root, jcfg.tiny_test_config(use_cam=True, **kw),
                 tcfg.tiny_test_config(use_cam=True, **kw), epochs=(0,))


def test_loader_threads_give_the_sequential_batches(tree):
    """Eight loader threads decoding and re-rendering at once (the remap
    cache's in-flight path) give the batches of the sequential samples."""
    cfg = tcfg.tiny_test_config(use_cam=True, seed=6, **VARIANTS['fisheyes'])
    ds = AiMotiveDataset(tree, cfg, 'train')
    ref = AiMotiveDataset(tree, cfg, 'train')
    from mm_training_tpu_torch.data.sensor_models import CameraModel
    CameraModel._remap_cache.clear()
    loader = PrefetchLoader(ds, 1, shuffle=True, num_workers=8, seed=6)
    try:
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            ref.set_epoch(epoch)
            plan = [list(b) for b in loader._batches()]
            for batch, idx in zip(loader, plan):
                _assert_same(batch, collate_aim([ref[i] for i in idx]))
    finally:
        loader.close()


_NO_IMAGE_CODEC = '''
import sys
for banned in ('cv2', 'PIL', 'jax', 'mm_training_tpu'):
    sys.modules[banned] = None        # any import of them raises ImportError
import tempfile
from mm_training_tpu_torch.configs import tiny_test_config
from mm_training_tpu_torch.data import AiMotiveDataset, generate_synthetic_dataset
root = tempfile.mkdtemp()
generate_synthetic_dataset(root, splits=('train',), frames_per_sequence=1, n_objects=2,
                           img_hw=(64, 128), fisheyes=True, n_ground_points=300)
s = AiMotiveDataset(root, tiny_test_config(use_cam=True, virtualize_fisheyes=True,
                                           num_cameras=6), 'train')[0]
print(s['imgs'].shape)
'''


def test_camera_path_runs_without_cv2_or_pil():
    out = subprocess.run([sys.executable, '-c', _NO_IMAGE_CODEC], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split('\n')[0] == '(1, 6, 64, 128, 3)'
