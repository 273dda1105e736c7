"""The port's host data pipeline against the JAX package's: the LAS/LAZ
codec, the native point packer, the aiMotive dataset and its collate, and
the synthetic tree writer, byte for byte on the same inputs and seeds. Also
the two reader faults the port's copies repair. Trees are written by the JAX
writer in the test's own directory (the camera data path's tests are
``test_torch_data_camera.py``)."""
import filecmp
import os
import struct

import numpy as np
import pytest

import mm_training_tpu.configs as jcfg
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu.data import AiMotiveDataset as JDataset
from mm_training_tpu.data import collate_aim as j_collate
from mm_training_tpu.data import lasio as jlasio
from mm_training_tpu.data import loaders as jloaders
from mm_training_tpu.data import native as jnative
from mm_training_tpu.data.synthetic import generate_synthetic_dataset as j_generate
from mm_training_tpu_torch.data import AiMotiveDataset, collate_aim, generate_synthetic_dataset
from mm_training_tpu_torch.data import lasio, loaders, native

PC_RANGE = (-204.8, -25.6, -5.0, 204.8, 25.6, 3.0)


def _cloud(n, seed=0, t0=3600.0):
    """A lidar frame as tests/test_data/test_lasio.py makes it."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, n)
    r = rng.gamma(3.0, 15.0, n)
    return np.stack([r * np.cos(az), r * np.sin(az), rng.normal(0, 3, n),
                     rng.integers(0, 256, n).astype(float),
                     np.sort(rng.uniform(0, 0.1, n)) + t0], axis=1)


def _bytes(path):
    with open(path, 'rb') as f:
        return f.read()


# ------------------------------------------------------------------- codec

@pytest.mark.parametrize('ext', ['laz', 'las'])
@pytest.mark.parametrize('n', [1, 2, 100, 4999, 5000, 5001, 12345])
def test_codec_reads_and_writes_as_jax(tmp_path, n, ext):
    """Both writers write the same bytes at the chunk boundaries of
    tests/test_data/test_lasio.py, and each reader reads the other's file
    bit for bit."""
    pts = _cloud(n, seed=n)
    mine, theirs = str(tmp_path / f'p.{ext}'), str(tmp_path / f'j.{ext}')
    assert lasio.write_las(mine, pts, chunk_size=5000) == n
    assert jlasio.write_las(theirs, pts, chunk_size=5000) == n
    assert _bytes(mine) == _bytes(theirs)
    want = jlasio.read_las(mine)
    assert want.shape == (n, 5)
    np.testing.assert_array_equal(lasio.read_las(theirs), want)
    np.testing.assert_array_equal(lasio.read_las(mine), jlasio.read_las(theirs))
    assert lasio.las_info(mine) == jlasio.las_info(theirs)


def _stream_written(path_in, path_out):
    """The LAZ file at ``path_in`` as LASzip writes it to a stream it cannot
    seek back in: -1 in the chunk-table offset field, the table's offset
    appended as the last 8 bytes."""
    raw = bytearray(_bytes(path_in))
    otp = struct.unpack('<I', raw[96:100])[0]
    table = raw[otp:otp + 8]
    raw[otp:otp + 8] = struct.pack('<q', -1)
    with open(path_out, 'wb') as f:
        f.write(bytes(raw) + bytes(table))


def test_stream_written_laz_reads_in_the_port_only(tmp_path):
    """A stream-written LAZ file: the JAX package's codec refuses it as
    corrupt (``mm_training_tpu/data/csrc/lasio.cpp:1143``); the port's reads
    the same points as from the seekable file."""
    pts = _cloud(12345, seed=3)
    seekable, stream = str(tmp_path / 'a.laz'), str(tmp_path / 'b.laz')
    lasio.write_las(seekable, pts, chunk_size=5000)
    _stream_written(seekable, stream)
    with pytest.raises(RuntimeError, match='corrupt'):
        jlasio.read_las(stream)
    np.testing.assert_array_equal(lasio.read_las(stream), lasio.read_las(seekable))


def test_npy_sibling_read_without_laspy(tmp_path, monkeypatch):
    """A LAZ frame the codec cannot decode, a same-named ``.npy`` beside it,
    no laspy: the JAX package's reader raises (its ``.npy`` fallback is
    never tried, ``mm_training_tpu/data/loaders.py:172``); the port's reads
    the ``.npy``. Without the ``.npy`` the port raises, naming the file."""
    monkeypatch.setattr(jloaders, 'laspy', None)
    monkeypatch.setattr(loaders, 'laspy', None)
    bad = tmp_path / 'frame_0000001.laz'
    lasio.write_las(str(bad), _cloud(5000), chunk_size=1000)
    bad.write_bytes(_bytes(bad)[:-2000])         # truncated: the codec refuses it
    pts = _cloud(50).astype(np.float32)
    with pytest.raises(RuntimeError, match='lasio'):
        jloaders.read_lidar(str(bad))
    with pytest.raises(RuntimeError, match='frame_0000001.laz'):
        loaders.read_lidar(str(bad))
    np.save(tmp_path / 'frame_0000001.npy', pts)
    with pytest.raises(RuntimeError, match='lasio'):
        jloaders.read_lidar(str(bad))
    np.testing.assert_array_equal(loaders.read_lidar(str(bad)), pts)
    with pytest.raises(FileNotFoundError, match='frame_0000002'):
        loaders.read_lidar(str(tmp_path / 'frame_0000002.laz'))


# ------------------------------------------------------------ point packer

def _lidar_radar(n_lidar, n_radar=100, seed=0):
    rng = np.random.default_rng(seed)
    lidar = np.concatenate([
        rng.uniform(-250, 250, (n_lidar, 2)), rng.uniform(-3, 3, (n_lidar, 1)),
        rng.uniform(0, 255, (n_lidar, 1)), rng.uniform(1000, 1001, (n_lidar, 1)),
    ], axis=1).astype(np.float32)
    radar = np.concatenate([
        rng.uniform(-250, 250, (n_radar, 2)), rng.uniform(-3, 3, (n_radar, 1)),
        rng.uniform(-30, 30, (n_radar, 1)), rng.uniform(0, 40, (n_radar, 1)),
    ], axis=1).astype(np.float32)
    return lidar, radar


@pytest.mark.parametrize('cap', [1000, 50_000])
@pytest.mark.parametrize('seed', [7, 2**40 + 3])
def test_point_packer_equals_jax(cap, seed):
    """concat_filter and pack_points (subsample below the cap, a 64-bit
    seed, a rotated BDA) give the JAX package's bytes."""
    lidar, radar = _lidar_radar(20000)
    pts = native.concat_filter_native(lidar, radar, PC_RANGE, 1000.5)
    want = jnative.concat_filter_native(lidar, radar, PC_RANGE, 1000.5)
    assert pts.tobytes() == want.tobytes()
    c, s = np.cos(0.3), np.sin(0.3)
    bda = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32) * 1.03
    before = pts.copy()
    got = native.pack_points_native(pts, bda, 1000.5, cap, seed)
    ref = jnative.pack_points_native(want, bda, 1000.5, cap, seed)
    np.testing.assert_array_equal(pts, before)          # the caller's array untouched
    assert got[0].tobytes() == ref[0].tobytes()
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2]


# ----------------------------------------------------------------- dataset

@pytest.fixture(scope='module', params=['npy', 'laz'])
def tree(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(f'aim_{request.param}'))
    j_generate(root, splits=('train', 'val'), odds=('highway', 'urban'),
               frames_per_sequence=2, n_objects=8, write_images=False,
               lidar_format=request.param)
    return root


def _assert_same(a, b):
    assert list(a) == list(b)
    for k in a:
        if k == 'path':
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize('variant', ['lidar_radar', 'lidar_only'])
def test_dataset_equals_jax(tree, variant):
    """Every array of every sample and of the collated batch equal to the
    JAX dataset's: the train split with its BDA at epochs 0 and 1, and the
    val split; the point cap below the frames' ~6,900 points, so the native
    subsample runs."""
    jc = getattr(jcfg, variant)(max_points_per_frame=4000, seed=3)
    tc = getattr(tcfg, variant)(max_points_per_frame=4000, seed=3)
    for split, epochs in (('train', (0, 1)), ('val', (0,))):
        jd, td = JDataset(tree, jc, split), AiMotiveDataset(tree, tc, split)
        assert td.dataset_index == jd.dataset_index and len(td) == 4
        for epoch in epochs:
            jd.set_epoch(epoch)
            td.set_epoch(epoch)
            js = [jd[i] for i in range(len(jd))]
            ts = [td[i] for i in range(len(td))]
            for a, b in zip(js, ts):
                _assert_same(a, b)
            _assert_same(j_collate(js), collate_aim(ts))
        if split == 'train':
            assert not np.allclose(ts[0]['bda_mat'], np.eye(4))
            assert ts[0]['gt_mask'].any() and ts[0]['point_mask'].all()


@pytest.mark.parametrize('fmt,images', [('npy', False), ('npy', True), ('laz', False)])
def test_writer_equals_jax(tmp_path, fmt, images):
    """The port's writer writes the JAX writer's non-image files, byte for
    byte (with images on, both draw the same image pixels first)."""
    kw = dict(splits=('train', 'val'), frames_per_sequence=2, n_objects=4, img_hw=(64, 128),
              write_images=images, lidar_format=fmt, n_ground_points=1500, seed=11)
    generate_synthetic_dataset(str(tmp_path / 'p'), **kw)
    j_generate(str(tmp_path / 'j'), **kw)
    files = []
    for dirpath, _, names in os.walk(tmp_path / 'j'):
        files += [os.path.relpath(os.path.join(dirpath, n), tmp_path / 'j') for n in names]
    assert len(files) > 10
    for rel in files:
        if rel.endswith('.jpg'):
            assert (tmp_path / 'p' / rel).is_file()
            continue
        assert filecmp.cmp(tmp_path / 'p' / rel, tmp_path / 'j' / rel, shallow=False), rel
