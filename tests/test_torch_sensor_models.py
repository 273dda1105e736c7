"""The port's camera models (``data/sensor_models``) against the JAX
package's: rays, projections and their invalid masks, serialization, and
``remap_from`` byte for byte (the JAX package's through cv2.convertMaps +
cv2.remap, the port's through its own ``data/image.py``), including rays
behind a camera and a Mei fisheye re-rendered into a yawed pinhole; plus
the cases of ``tests/test_data/test_sensor_models.py`` run on the port's
copy (round trips, remap identity, the remap cache under eviction and its
in-flight dedup)."""
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from mm_training_tpu.data.sensor_models import cameras as jcam
from mm_training_tpu_torch.data.sensor_models import cameras as tcam

K = np.array([[120.0, 0, 80.0], [0, 118.0, 60.0], [0, 0, 1.0]])
SIZE = (120, 160)
DIST = np.array([-0.1, 0.02, 1e-3, -1e-3, 0.0])
MEI_DIST = np.array([-0.05, 0.01, 0.0, 0.0, 0.0])


def _pair(name, mod, rotation=None):
    """(model name, the model built from ``mod``) for each camera model."""
    return {
        'pinhole': lambda: mod.CameraPinhole(K, SIZE, rotation),
        'distorted': lambda: mod.CameraPinholeDistorted(K, DIST, SIZE, rotation),
        'mei': lambda: mod.CameraMei(K, 0.8, MEI_DIST, SIZE, rotation),
        'equirect': lambda: mod.CameraEquirect(SIZE, rotation=rotation),
    }[name]()


MODELS = ['pinhole', 'distorted', 'mei', 'equirect']


@pytest.mark.parametrize('name', MODELS)
def test_rays_and_projections_equal_jax(name):
    """image2ray on the full grid and ray2image on rays in every direction
    (behind the camera included): the same values and invalid masks."""
    j, t = _pair(name, jcam), _pair(name, tcam)
    np.testing.assert_array_equal(t.grid_rays(), j.grid_rays())
    rng = np.random.default_rng(0)
    rays = rng.normal(size=(500, 3)).astype(np.float32)
    (jp, ji), (tp, ti) = j.ray2image(rays), t.ray2image(rays)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ti, ji)
    assert np.asarray(ti).any() or name in ('mei', 'equirect')


@pytest.mark.parametrize('name', MODELS)
def test_round_trip_and_serialization(name):
    """ray2image(image2ray(px)) == px (as the JAX test holds it), and a
    dict round trip through JSON gives the same model, the same dict as
    the JAX model's."""
    model = _pair(name, tcam)
    rng = np.random.default_rng(0)
    px = np.stack([rng.uniform(SIZE[1] * 0.25, SIZE[1] * 0.75, 200),
                   rng.uniform(SIZE[0] * 0.25, SIZE[0] * 0.75, 200)], -1)
    rays = model.image2ray(px)
    px2, invalid = model.ray2image(rays)
    ok = ~np.asarray(invalid, bool)
    assert ok.mean() > 0.95
    np.testing.assert_allclose(px2[ok], px[ok], atol=0.05)
    d = json.loads(json.dumps(model.save_to_dict()))
    assert d == json.loads(json.dumps(_pair(name, jcam).save_to_dict()))
    m2 = tcam.make_from_dict(d)
    assert type(m2) is type(model)
    np.testing.assert_allclose(model.image2ray(px), m2.image2ray(px), atol=1e-9)


@pytest.mark.parametrize('source,yaw', [('pinhole', 0.0), ('pinhole', 10.0),
                                        ('distorted', 25.0), ('mei', -30.0),
                                        ('mei', 100.0), ('equirect', 45.0)])
def test_remap_from_equals_jax(source, yaw):
    """A pinhole yawed by ``yaw`` re-renders the source's image: the same
    bytes as the JAX package's cv2 remap, rays outside or behind the source
    black in both."""
    rot = Rotation.from_euler('y', yaw, degrees=True).as_matrix()
    rng = np.random.default_rng(int(yaw) + 360)
    img = rng.integers(0, 256, SIZE + (3,), dtype=np.uint8)
    jt = jcam.CameraPinhole(K, (96, 144), rot)
    tt = tcam.CameraPinhole(K, (96, 144), rot)
    want = jt.remap_from(_pair(source, jcam), img, use_cache=False)
    got = tt.remap_from(_pair(source, tcam), img)
    assert got.shape == want.shape == (96, 144, 3)
    assert got.tobytes() == want.tobytes()
    if source == 'pinhole' and yaw:
        assert (got == 0).all(-1).any()                     # rays that miss the source


def test_remap_identity():
    cam = tcam.CameraPinhole(K, SIZE)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, SIZE + (3,), np.uint8)
    out = cam.remap_from(cam, img)
    inner = (slice(10, -10), slice(10, -10))
    diff = np.abs(out[inner].astype(int) - img[inner].astype(int))
    assert np.median(diff) <= 1


def test_remap_cache_thread_safe_under_eviction():
    """More live (target, source) pairs than the cache holds, hit from 8
    threads: no KeyError from a touch racing an eviction, the cache bounded."""
    size = (12, 16)
    img = np.zeros(size + (3,), np.uint8)
    n_cams = tcam.CameraModel._REMAP_CACHE_MAX + 16
    cams = [tcam.CameraPinhole(K * (1 + 0.01 * i), size) for i in range(n_cams)]
    tcam.CameraModel._remap_cache.clear()

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(60):
            cam = cams[int(rng.integers(n_cams))]
            cam.remap_from(cam, img)
        return True

    with ThreadPoolExecutor(max_workers=8) as pool:
        assert all(pool.map(worker, range(16)))
    assert len(tcam.CameraModel._remap_cache) <= tcam.CameraModel._REMAP_CACHE_MAX


def test_remap_inflight_dedup_computes_once(monkeypatch):
    """Concurrent misses on one key compute the table once; the others wait
    on the first thread's in-flight event."""
    size = (12, 16)
    img = np.zeros(size + (3,), np.uint8)
    cam = tcam.CameraPinhole(K, size)
    tcam.CameraModel._remap_cache.clear()
    calls = []
    lock = threading.Lock()
    orig = tcam.CameraPinhole.ray2image

    def counting(self, rays):
        with lock:
            calls.append(threading.get_ident())
        time.sleep(0.05)
        return orig(self, rays)

    monkeypatch.setattr(tcam.CameraPinhole, 'ray2image', counting)
    start = threading.Barrier(8)

    def worker(_):
        start.wait(timeout=30)
        return cam.remap_from(cam, img).shape

    with ThreadPoolExecutor(max_workers=8) as pool:
        shapes = list(pool.map(worker, range(8), timeout=60))
    assert all(s == shapes[0] for s in shapes)
    assert len(calls) == 1, f'remap computed {len(calls)}x for one key'
