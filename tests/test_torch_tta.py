"""The port's 4-way flip ensemble (``training/tta.py``, the eval and predict
steps under ``use_tta``) against the JAX package's ``training/tta.py`` and
``make_eval_step``, on the tiny LiDAR+radar config at narrow widths in fp32
with random flax variables carried over by ``state_dict_from_flax``; the
camera case is ``test_torch_tta_camera.py``."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mm_training_tpu.configs as jcfg
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu.data.fake_batch import make_fake_batch as j_fake_batch
from mm_training_tpu.models import BEVDepthLiDAR as JModel
from mm_training_tpu.models import decode_boxes as j_decode
from mm_training_tpu.training.train_step import TrainState as JState
from mm_training_tpu.training.train_step import _prepare_camera_inputs
from mm_training_tpu.training.train_step import make_eval_step as j_eval_step
from mm_training_tpu.training.tta import tta_forward as j_tta_forward
from mm_training_tpu_torch.data import make_fake_batch
from mm_training_tpu_torch.models import BEVDepthLiDAR, decode_boxes, state_dict_from_flax
from mm_training_tpu_torch.training import (camera_inputs, create_train_state, make_eval_step,
                                            make_predict_step)
from mm_training_tpu_torch.training.tta import _correct_pred, tta_forward
from tests.torch_port_helpers import _compare_boxes, narrow, narrow_cam, random_variables


def _case(camera: bool):
    """Both packages' models on the same weights and batch: (JAX config,
    model, variables, jnp batch; port config, model, numpy batch)."""
    kw = dict(use_cam=camera, use_radar=True, use_tta=True, precision='fp32')
    widen = narrow_cam if camera else narrow
    jc, tc = widen(jcfg, jcfg.tiny_test_config(**kw)), widen(tcfg, tcfg.tiny_test_config(**kw))
    batch = make_fake_batch(tc, seed=3)
    jbatch = j_fake_batch(jc, seed=3)
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
    jm = JModel(jc)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    b, s, n = jb['imgs'].shape[:3]
    v = random_variables(jm.init, dict(jb, flipped=jnp.zeros((b * s * n,), bool)), seed=4)
    model = BEVDepthLiDAR(tc, device='cpu')
    model.load_state_dict(state_dict_from_flax(v['params'], v['batch_stats'], tc))
    return jc, jm, v, jb, tc, model, batch


@pytest.fixture(scope='module')
def case():
    """The LiDAR+radar case; ``test_torch_tta_camera.py`` runs the same
    tests on the camera case (a file of its own, so the two JAX compiles
    run on two workers)."""
    return _case(False)


class _Members:
    """Stands in for the JAX model in ``tta_forward``: ``apply`` returns the
    port model's own prediction for the flip of the points it is given, so
    both ensembles combine the same four members."""

    def __init__(self, model, mask, cam):
        self.model, self.mask, self.cam = model, mask, cam

    def apply(self, variables, batch, oracle, train):
        flipped = torch.from_numpy(np.array(batch['points']))
        with torch.no_grad():
            preds, depth = self.model(flipped, self.mask, **self.cam, return_depth=True)
        return ([{k: jnp.asarray(t.numpy()) for k, t in p.items()} for p in preds],
                None if depth is None else jnp.asarray(depth.numpy()), None, None)


def _compare_decoded(got, want, slots: int = 83) -> None:
    """Decoded boxes as :func:`_compare_boxes` holds them (labels, scores
    1e-4, boxes 1e-3, matched by label and score), both ways, except at a
    task's top-k cut: a box whose score lies within 1e-4 of the lowest kept
    score of its task's ``slots`` may be kept on one side only (near-tied
    scores trade places there, ROADMAP section 3)."""
    for (gb, gs, gl, gv), (wb, ws, wl, wv) in ((got, want), (want, got)):
        assert wv.sum() > 50
        for b, i in zip(*np.nonzero(wv)):
            block = slice(i // slots * slots, (i // slots + 1) * slots)
            cut = ws[b, block][wv[b, block]].min()
            same = gv[b] & (gl[b] == wl[b, i]) & (np.abs(gs[b] - ws[b, i]) <= 1e-4)
            err = np.abs(gb[b, same] - wb[b, i]).max(-1) if same.any() else [np.inf]
            assert np.min(err) <= 1e-3 or ws[b, i] - cut <= 1e-4, (b, i, wb[b, i], ws[b, i])


def _max_map_diff(got, want):
    return max(float(np.abs(g[k].numpy() - np.asarray(w[k])).max())
               for g, w in zip(got, want) for k in w)


def test_tta_forward_matches_jax(case):
    """The ensemble: on the same four members (the port model's, through a
    stand-in for the JAX model) the two ensembles agree within 1e-5 and
    decode to the same boxes (labels and valid equal, scores 1e-4, boxes
    1e-3 m, matched by label and score). The whole forward against the JAX
    model's: the maps within 1e-4 (of each map's scale, at least 1) and the
    same boxes, also from the predict step. With the camera, whose plain
    forward already differs from the JAX one by up to ~3e-2 in the maps
    (measured here: frustum points on a cell boundary of the fake rig's
    axis-aligned cameras land in the neighbouring cell in the other
    package, 4 of the 1,024 camera BEV cells, ROADMAP section 3), the maps
    are held within that plain difference and the count of kept boxes
    within 1%."""
    jc, jm, v, jb, tc, model, batch = case
    if jc.use_cam:
        model_batch, _, oracle = _prepare_camera_inputs(jc, jb, None, training=False)
    else:
        model_batch = dict(jb, flipped=jnp.zeros((jb['imgs'].shape[0],), bool))
        oracle = None
    pts = torch.from_numpy(batch['points'])
    mask = torch.from_numpy(batch['point_mask'])
    cam = camera_inputs(tc, batch, 'cpu', pts, mask) if tc.use_cam else {}
    if tc.use_cam:
        assert cam['depth_oracle'] is not None
        np.testing.assert_allclose(cam['depth_oracle'].numpy(), np.asarray(oracle))
    with torch.no_grad():
        got, got_depth = tta_forward(model, None, pts, mask, cam)

    shared, _ = j_tta_forward(jc, _Members(model, mask, cam), v, model_batch, oracle)
    assert _max_map_diff(got, shared) <= 1e-5
    _compare_decoded([a.numpy() for a in decode_boxes(tc.get_head_conf(), got)],
                     [np.asarray(a) for a in j_decode(jc.get_head_conf(), shared)])

    want, want_depth = jax.jit(functools.partial(j_tta_forward, jc, jm))(v, model_batch, oracle)
    assert len(got) == len(want)
    if jc.use_cam:
        plain_want = jax.jit(jm.apply, static_argnums=3)(v, model_batch, oracle, False)[0]
        with torch.no_grad():
            plain_got = model(pts, mask, **cam)
        floor = _max_map_diff(plain_got, plain_want)
        assert 0 < floor < 0.05
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            wk = np.asarray(w[k])
            assert g[k].dtype == torch.float32 and g[k].shape == wk.shape, k
            tol = floor if jc.use_cam else 1e-4 * max(1.0, np.abs(wk).max())
            assert np.abs(g[k].numpy() - wk).max() <= tol, k
    if jc.use_cam:
        wd = np.asarray(want_depth).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got_depth.numpy(), wd, atol=1e-5)
    want_boxes = [np.asarray(a) for a in j_decode(jc.get_head_conf(), want)]
    for boxes in (decode_boxes(tc.get_head_conf(), got), make_predict_step(tc, model)(batch)):
        boxes = [a.numpy() for a in boxes]
        if not jc.use_cam:
            _compare_decoded(boxes, want_boxes)
        else:    # as many boxes kept, within the plain forward's own spread
            assert abs(int(boxes[3].sum()) - int(want_boxes[3].sum())) <= 0.01 * want_boxes[3].sum()


def test_eval_step_with_tta_matches_jax(case):
    """The eval step under ``use_tta``: losses within 1e-5 relative of the
    JAX eval step's, boxes as the predict parity holds them."""
    jc, jm, v, jb, tc, model, batch = case
    jstate = JState(step=jnp.zeros((), jnp.int32), params=v['params'],
                    batch_stats=v['batch_stats'], opt_state=None)
    j_met, j_out, _ = j_eval_step(jc, jm)(jstate, jb)
    state = create_train_state(tc, model)
    p_met, p_out, _ = make_eval_step(tc)(state, batch)
    keys = ('detection_loss', 'depth_loss', 'loss') if tc.use_cam else ('detection_loss', 'loss')
    for k in keys:
        assert abs(float(p_met[k]) - float(j_met[k])) <= 1e-5 * abs(float(j_met[k])), k
    _compare_boxes([a.numpy() for a in p_out], [np.asarray(a) for a in j_out])


def test_tta_yaw_correction_is_a_reflection():
    """The port of the JAX package's regression test: negating the x axis
    is a REFLECTION, so the x-flip yaw correction is pi - rot (the
    reference's rot - pi cancels the sine of every yaw across the 4-way
    average). For an exactly flip-equivariant synthetic prediction, the
    corrected map of every member equals the canonical map."""
    rng = np.random.default_rng(0)
    h, w = 6, 8
    theta = rng.uniform(-np.pi, np.pi, (1, h, w)).astype(np.float32)
    vel = rng.normal(size=(1, h, w, 2)).astype(np.float32)
    ref_rot = np.stack([np.sin(theta), np.cos(theta)], -1)
    for fx in (1.0, -1.0):
        for fy in (1.0, -1.0):
            th, vl = theta.copy(), vel.copy()
            if fx < 0:
                th = np.pi - th
                vl = vl * np.asarray([-1.0, 1.0], np.float32)
                th, vl = th[:, :, ::-1], vl[:, :, ::-1]
            if fy < 0:
                th = -th
                vl = vl * np.asarray([1.0, -1.0], np.float32)
                th, vl = th[:, ::-1], vl[:, ::-1]
            pred = {'rot': torch.from_numpy(np.stack([np.sin(th), np.cos(th)], -1).copy()),
                    'vel': torch.from_numpy(np.ascontiguousarray(vl))}
            out = _correct_pred(pred, fx, fy)
            np.testing.assert_allclose(out['rot'].numpy(), ref_rot, atol=1e-5)
            np.testing.assert_allclose(out['vel'].numpy(), vel, atol=1e-6)
