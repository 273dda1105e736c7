"""The port's renderer (``utils/renderer.py``: its own lines, filled
circles and JET table in place of cv2's) byte for byte against the JAX
package's renderer under cv2, and the logger's panels (the port's PNG
encoder, read back by cv2) and 3D scenes against the JAX logger's files."""
import types

import cv2
import numpy as np
import pytest

from mm_training_tpu.utils import logging as j_logging
from mm_training_tpu.utils import renderer as jr
from mm_training_tpu_torch.configs import lidar_cam_radar, tiny_test_config
from mm_training_tpu_torch.data import make_fake_batch
from mm_training_tpu_torch.utils import logging as t_logging
from mm_training_tpu_torch.utils import renderer as tr


def _boxes(rng, n, x_range, y_range):
    """[n, 9] gravity-centre boxes: x, y, z, dx, dy, dz, yaw, vx, vy."""
    out = np.zeros((n, 9), np.float32)
    out[:, 0] = rng.uniform(*x_range, n)
    out[:, 1] = rng.uniform(*y_range, n)
    out[:, 2] = rng.uniform(-1.0, 1.5, n)
    out[:, 3:6] = rng.uniform(0.5, 12.0, (n, 3))
    out[:, 6] = rng.uniform(-np.pi, np.pi, n)
    out[:, 7:] = rng.normal(size=(n, 2))
    return out


def _points(rng, n, radar_share=0.1, extent=(-60, 60, -30, 30)):
    pts = np.zeros((n, 8), np.float32)
    pts[:, 0] = rng.uniform(extent[0], extent[1], n)
    pts[:, 1] = rng.uniform(extent[2], extent[3], n)
    pts[:, 2] = rng.uniform(-2, 3, n)
    pts[:, 3] = rng.random(n) < radar_share
    pts[:, 6] = rng.random(n)
    return pts


def test_clip_and_lines_match_cv2():
    """``draw_line`` and ``fill_circle`` against cv2.line (thickness 1,
    LINE_8) and a filled cv2.circle on random segments and centres, inside,
    across and far outside small images; the JET table against
    cv2.applyColorMap on all 256 levels."""
    rng = np.random.default_rng(0)
    for _ in range(3000):
        h, w = (int(v) for v in rng.integers(1, 50, 2))
        scale = int(rng.choice([1, 4, 40]))
        p1 = tuple(int(v) for v in rng.integers(-scale * 50, scale * 50 + 50, 2))
        p2 = tuple(int(v) for v in rng.integers(-scale * 50, scale * 50 + 50, 2))
        a, b = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3), np.uint8)
        cv2.line(a, p1, p2, (255, 1, 2), 1, cv2.LINE_8)
        tr.draw_line(b, p1, p2, (255, 1, 2))
        assert np.array_equal(a, b), (h, w, p1, p2)
        inside, q1, q2 = cv2.clipLine((0, 0, w, h), p1, p2)
        got = tr.clip_line((w, h), p1, p2)
        assert got[0] == inside and (not inside or (got[1], got[2]) == (q1, q2))
        c = (int(rng.integers(-8, w + 8)), int(rng.integers(-8, h + 8)))
        r = int(rng.integers(0, 9))
        cv2.circle(a, c, r, (3, 200, 7), -1)
        tr.fill_circle(b, c, r, (3, 200, 7))
        assert np.array_equal(a, b), (h, w, c, r)
    levels = np.arange(256, dtype=np.uint8)[None]
    np.testing.assert_array_equal(tr.JET, cv2.applyColorMap(levels, cv2.COLORMAP_JET)[0])


@pytest.mark.parametrize('px_per_m', [2.0, 5.0])
def test_render_bev_matches_jax(px_per_m):
    """LiDAR and radar points, GT boxes and class-coloured predictions, some
    boxes partly or wholly off the raster."""
    rng = np.random.default_rng(int(px_per_m))
    pc = lidar_cam_radar().point_cloud_range
    pts = _points(rng, 20000, extent=(-220, 220, -35, 35))
    gt = _boxes(rng, 30, (-210, 210), (-30, 30))
    pred = _boxes(rng, 40, (-210, 210), (-30, 30))
    labels = rng.integers(0, 7, 40)
    kw = dict(gt_boxes=gt, pred_boxes=pred, pred_labels=labels, pc_range=pc, px_per_m=px_per_m)
    want = jr.render_bev(pts, **kw)
    got = tr.render_bev(pts, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert (want == 255).all(-1).sum() > 100          # GT wireframes drawn
    assert np.array_equal(tr.render_bev(None), jr.render_bev(None))


def _camera(cfg, seed):
    batch = make_fake_batch(cfg, seed=seed)
    return (batch['extrinsics'][0, 0, 0].astype(np.float64), batch['intrin'][0, 0, 0],
            batch['imgs'][0, 0, 0])


@pytest.mark.parametrize('seed', [0, 1])
def test_camera_overlays_match_jax(seed):
    """Points (LiDAR dots, radar discs, some at the image edge) and box
    wireframes (GT white, predictions by label) projected into a camera
    image: boxes partly off the image and behind the camera among them."""
    cfg = tiny_test_config(use_cam=True)
    extr, intr, img = _camera(cfg, seed)
    rng = np.random.default_rng(seed)
    pts = _points(rng, 30000, radar_share=0.05, extent=(-40, 40, -40, 40))
    boxes = _boxes(rng, 60, (-40, 40), (-40, 40))
    labels = rng.integers(0, 5, 60)
    want = jr.draw_points_camera(img, pts, extr, intr)
    got = tr.draw_points_camera(img, pts, extr, intr)
    assert np.array_equal(got, want) and not np.array_equal(want, img)
    for kw in (dict(color=(255, 255, 255)), dict(labels=labels), dict()):
        w = jr.draw_boxes_camera(want, boxes, extr, intr, **kw)
        g = tr.draw_boxes_camera(got, boxes, extr, intr, **kw)
        assert np.array_equal(g, w), kw
        assert not np.array_equal(w, want)
    cam = (extr[:3, :3] @ np.stack([tr.box_corners_3d(b) for b in boxes]).reshape(-1, 3).T
           + extr[:3, 3:4])
    assert (cam[2].reshape(60, 8) < 0.5).all(1).any()      # a box behind the camera


@pytest.mark.parametrize('shapes', [[(32, 64)], [(8, 16), (16, 32), (32, 8)], [(1, 1), (5, 3)]])
def test_heatmap_and_depth_panels_match_jax(shapes):
    rng = np.random.default_rng(len(shapes))
    hms = [rng.random(s).astype(np.float32) * 1.2 - 0.1 for s in shapes]
    assert np.array_equal(tr.render_heatmap_panel(hms), jr.render_heatmap_panel(hms))
    h, w = shapes[-1]
    depth = rng.random((h, w, 50)).astype(np.float32)
    depth /= depth.sum(-1, keepdims=True)
    d_bound = (2.0, 58.0, 0.5)
    assert np.array_equal(tr.render_depth_panel(depth, d_bound),
                          jr.render_depth_panel(depth, d_bound))


def test_renderer_class_matches_jax():
    cfg = tiny_test_config(use_cam=True)
    extr, intr, img = _camera(cfg, 2)
    rng = np.random.default_rng(2)
    params = types.SimpleNamespace(extrinsic=extr, intrinsic=intr)
    frame = types.SimpleNamespace(
        points=_points(rng, 5000, extent=(-40, 40, -40, 40)),
        objects=_boxes(rng, 12, (-40, 40), (-40, 40)),
        cameras=[types.SimpleNamespace(name='F', image=img, camera_params=params),
                 types.SimpleNamespace(name='B', image=None, camera_params=params)])
    pred = _boxes(rng, 8, (-40, 40), (-40, 40))
    labels = rng.integers(0, 5, 8)
    for mod_a, mod_b in ((tr, jr),):
        a, b = mod_a.Renderer(px_per_m=2.0), mod_b.Renderer(px_per_m=2.0)
        assert np.array_equal(a.render_frame_bev(frame, pred, labels),
                              b.render_frame_bev(frame, pred, labels))
        ca, cb = (r.render_frame_cameras(frame, pred, labels) for r in (a, b))
        assert [n for n, _ in ca] == [n for n, _ in cb] == ['F']
        assert np.array_equal(ca[0][1], cb[0][1])


def test_png_and_scene_files_match_the_jax_logger(tmp_path):
    """``log_image``'s PNG, read back by cv2, equals the panel (BGR and
    grey); its IHDR and IDAT are a plain 8-bit PNG; ``log_scene_3d`` writes
    the JAX logger's .ply and boxes JSON byte for byte."""
    rng = np.random.default_rng(5)
    panel = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    grey = rng.integers(0, 256, (9, 4), dtype=np.uint8)
    for img in (panel, grey):
        file = tmp_path / f'x{img.ndim}.png'
        file.write_bytes(t_logging.encode_png(img))
        np.testing.assert_array_equal(cv2.imread(str(file), cv2.IMREAD_UNCHANGED), img)
    port = t_logging.MetricsLogger(tmp_path / 'port', 'e', use_tensorboard=False)
    jax_logger = j_logging.MetricsLogger(tmp_path / 'jax', 'e', use_tensorboard=False)
    port.log_image(7, 'val_bev', panel)
    jax_logger.log_image(7, 'val_bev', panel)
    name = 'panels/val_bev_0000007.png'
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / 'port' / name)),
                                  cv2.imread(str(tmp_path / 'jax' / name)))
    pts = _points(rng, 3000)
    gt, pred = _boxes(rng, 5, (-40, 40), (-20, 20)), _boxes(rng, 4, (-40, 40), (-20, 20))
    for lg in (port, jax_logger):
        lg.log_scene_3d(12, 'val_scene', pts, gt_boxes=gt, pred_boxes=pred,
                        pred_labels=np.arange(4))
        lg.log_scene_3d(13, 'train_scene', pts[:, :4])
    for f in ('val_scene_0000012.ply', 'val_scene_0000012_boxes.json',
              'train_scene_0000013.ply', 'train_scene_0000013_boxes.json'):
        assert (tmp_path / 'port' / 'scenes' / f).read_bytes() == \
            (tmp_path / 'jax' / 'scenes' / f).read_bytes(), f
    port.close()
    jax_logger.jsonl.close()
    null = t_logging.NullLogger()
    null.log_image(1, 'x', panel)
    null.log_scene_3d(1, 'x', pts)
