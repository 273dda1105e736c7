"""The port's kernel modules against the JAX package, on the CPU.

On the CPU each wrapper runs its plain PyTorch version, so these tests hold
the plain versions (the card's oracle) to:
  * kernel A: the TPU kernel ``scripts/bn_elementwise_probe.py::_pallas_affine``
    in Pallas interpret mode, the probe's own XLA reference
    ``jnp.maximum(x*s + t [+ r], 0)``, and flax ``nn.BatchNorm`` eval + ReLU;
  * K1: ``mm_training_tpu.ops.voxelize_pillars_dense`` (vmapped);
  * K3: ``mm_training_tpu.ops.circle_nms_mask`` (per row), with each of the
    threshold forms the wrapper takes, and the decode that calls it
    (``mm_training_tpu.models.centerpoint_head.decode_boxes``).
Inputs come from numpy with a seed; fp32 throughout.
"""
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mm_training_tpu.ops import circle_nms_mask as jax_circle_nms_mask
from mm_training_tpu.ops import voxelize_pillars_dense as jax_voxelize
from mm_training_tpu_torch.models.bn_fold import BatchNorm2d
from mm_training_tpu_torch.ops import affine_act, circle_nms, voxelize
from scripts.bn_elementwise_probe import _pallas_affine
from tests.torch_port_helpers import nchw, nhwc


# ------------------------------------------------------------------ kernel A

def _affine_inputs(shape=(2, 8, 16, 64), seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            rng.normal(size=c).astype(np.float32),
            rng.normal(size=c).astype(np.float32))


@pytest.mark.parametrize('with_residual', [False, True])
def test_affine_plain_matches_pallas_probe(with_residual):
    x, r, s, t = _affine_inputs()
    res = jnp.asarray(r) if with_residual else None
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(_pallas_affine(jnp.asarray(x), jnp.asarray(s),
                                           jnp.asarray(t), residual=res,
                                           tile_rows=8))
    # the probe's XLA reference (bn_elementwise_probe.py:156-169)
    xla = np.maximum(x * s + t + (r if with_residual else 0.0), 0.0)
    before = affine_act.affine_act.launches
    got = nhwc(affine_act.affine_act(
        nchw(x), torch.from_numpy(s), torch.from_numpy(t),
        nchw(r) if with_residual else None, relu=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=1e-6, atol=1e-6)
    assert affine_act.affine_act.launches == before  # plain path: no launch


@pytest.mark.parametrize('relu', [True, False])
def test_batchnorm_matches_flax_eval(relu):
    x, _, _, _ = _affine_inputs(shape=(2, 6, 10, 24), seed=1)
    rng = np.random.default_rng(2)
    c = x.shape[-1]
    scale, bias = rng.normal(1, 0.2, c), rng.normal(0, 0.2, c)
    mean, var = rng.normal(0, 0.5, c), rng.uniform(0.5, 1.5, c)
    variables = {'params': {'scale': scale, 'bias': bias},
                 'batch_stats': {'mean': mean, 'var': var}}
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                       variables)
    want = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        variables, jnp.asarray(x))
    want = np.asarray(jnp.maximum(want, 0.0) if relu else want)

    bn = BatchNorm2d(c, relu=relu).eval()
    with torch.no_grad():
        for name, v in (('weight', scale), ('bias', bias),
                        ('running_mean', mean), ('running_var', var)):
            getattr(bn, name).copy_(torch.from_numpy(v))
        got = nhwc(bn(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_batchnorm_residual_no_relu():
    x, r, s, t = _affine_inputs(shape=(1, 4, 6, 16), seed=3)
    got = nhwc(affine_act.affine_act(nchw(x), torch.from_numpy(s),
                                     torch.from_numpy(t), nchw(r), relu=False))
    np.testing.assert_allclose(got, x * s + t + r, rtol=1e-6, atol=1e-6)


def test_batchnorm_refuses_training_mode():
    """Training mode runs now (batch statistics, flax's running average);
    what it refuses is a BatchNorm it cannot train with flax's semantics."""
    with pytest.raises(RuntimeError, match='momentum=None'):
        BatchNorm2d(4, momentum=None).train()(torch.zeros(1, 4, 2, 2))
    y = BatchNorm2d(4).train()(torch.ones(2, 4, 2, 2))
    assert torch.equal(y, torch.zeros_like(y))   # normalized by its own mean


# ------------------------------------------------------------------------ K1

PC_RANGE = (-4.0, -2.0, -5.0, 4.0, 2.0, 3.0)
VOXEL = (1.0, 1.0, 8.0)
GRID = (4, 8)  # (ny, nx)


def _points(b=2, n=400, seed=0, fill=0.9):
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, n, 8), np.float32)
    pts[..., 0] = rng.uniform(-5, 5, (b, n))      # some outside x range
    pts[..., 1] = rng.uniform(-3, 3, (b, n))
    pts[..., 2] = rng.uniform(-6, 4, (b, n))      # some outside z range
    pts[..., 3:] = rng.normal(size=(b, n, 5))
    return pts, rng.random((b, n)) < fill


def _jax_voxelize(pts, mask, cap, **geo):
    geo = {'pc_range': PC_RANGE, 'voxel_size': VOXEL, 'grid_hw': GRID, **geo}
    fn = jax.vmap(lambda p, m: jax_voxelize(p, m, max_points_per_voxel=cap,
                                            **geo))
    return np.asarray(fn(jnp.asarray(pts), jnp.asarray(mask)))


@pytest.mark.parametrize('cap', [None, 1, 3])
def test_voxelize_matches_jax(cap):
    pts, mask = _points()
    got = voxelize.voxelize_pillars_dense(
        torch.from_numpy(pts), torch.from_numpy(mask), PC_RANGE, VOXEL, GRID,
        max_points_per_voxel=cap).numpy()
    np.testing.assert_allclose(got, _jax_voxelize(pts, mask, cap),
                               rtol=1e-5, atol=1e-6)


def test_voxelize_tiny_geometry_and_lidar_features():
    """The tiny config's grid (128 x 256 at 0.2 m), 5 of 8 features."""
    rng = np.random.default_rng(4)
    pc, vs, grid = (-25.6, -12.8, -5.0, 25.6, 12.8, 3.0), (0.2, 0.2, 8.0), (128, 256)
    pts = np.zeros((2, 3000, 8), np.float32)
    for i, (lo, hi) in enumerate([(pc[0], pc[3]), (pc[1], pc[4]), (pc[2], pc[5])]):
        pts[..., i] = rng.uniform(lo, hi, pts.shape[:2])
    pts[..., 3:] = rng.normal(size=(2, 3000, 5))
    pts[:, ::7, :2] = np.round(pts[:, ::7, :2] / 0.2) * 0.2  # on cell borders
    mask = rng.random((2, 3000)) < 0.95
    got = voxelize.voxelize_pillars_dense(torch.from_numpy(pts),
                                          torch.from_numpy(mask), pc, vs, grid)
    want = _jax_voxelize(pts, mask, None, pc_range=pc, voxel_size=vs, grid_hw=grid)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_voxelize_empty_cloud_is_zero():
    pts, _ = _points()
    mask = np.zeros(pts.shape[:2], bool)
    got = voxelize.voxelize_pillars_dense(torch.from_numpy(pts),
                                          torch.from_numpy(mask), PC_RANGE, VOXEL,
                                          GRID)
    assert got.shape == (2, *GRID, 5) and not got.any()
    np.testing.assert_array_equal(got.numpy(), _jax_voxelize(pts, mask, None))


def test_voxelize_refuses_multiple_z_bins():
    pts, mask = _points()
    with pytest.raises(ValueError, match='pillar-only'):
        voxelize.voxelize_pillars_dense(torch.from_numpy(pts),
                                        torch.from_numpy(mask), PC_RANGE,
                                        (1.0, 1.0, 2.0), GRID)


@pytest.mark.parametrize('s2d,channels', [(True, None), (True, 24), (True, 32),
                                          (False, None), (False, 8)])
def test_pillar_encoder_input_plain_matches_jax(s2d, channels):
    """K1's encoder input (its plain version, which the CPU path runs)
    against what the JAX encoder hands its first conv: the vmapped
    voxelize, ``astype(bf16)`` and ``space_to_depth_2x2``, bit for bit, then
    zero channels up to ``channels``."""
    from mm_training_tpu.models.resnet import space_to_depth_2x2 as j_s2d
    pts, mask = _points()
    want = jnp.asarray(_jax_voxelize(pts, mask, None)).astype(jnp.bfloat16)
    if s2d:
        want = j_s2d(want)
    want = np.asarray(want.astype(jnp.float32))
    for fn in (voxelize.pillar_encoder_input, voxelize.pillar_encoder_input_plain):
        got = fn(torch.from_numpy(pts), torch.from_numpy(mask), PC_RANGE, VOXEL, GRID,
                 num_features=5, dtype=torch.bfloat16, space_to_depth=s2d, channels=channels)
        c = want.shape[-1]
        assert got.dtype == torch.bfloat16
        assert got.shape == (*want.shape[:-1], channels or c)
        np.testing.assert_array_equal(got[..., :c].float().numpy(), want)
        assert not got[..., c:].any()


def test_pillar_encoder_input_refusals():
    pts, mask = _points()
    args = (torch.from_numpy(pts), torch.from_numpy(mask), PC_RANGE, VOXEL)
    with pytest.raises(ValueError, match='channels'):
        voxelize.pillar_encoder_input(*args, GRID, channels=16)
    with pytest.raises(ValueError, match='even'):
        voxelize.pillar_encoder_input(*args, (3, 8))


# ------------------------------------------------------------------------ K3

def _jax_nms_rows(centers, scores, valid, thresh):
    return np.stack([np.asarray(jax_circle_nms_mask(
        jnp.asarray(c), jnp.asarray(s), jnp.asarray(v), float(t)))
        for c, s, v, t in zip(centers, scores, valid, thresh)])


def _port_nms(centers, scores, valid, thresh):
    return circle_nms.circle_nms_mask(
        torch.from_numpy(centers), torch.from_numpy(scores),
        torch.from_numpy(valid), torch.tensor(thresh, dtype=torch.float32)).numpy()


def test_circle_nms_matches_jax_per_row_thresholds():
    rng = np.random.default_rng(5)
    r, k = 4, 200
    centers = rng.uniform(-10, 10, (r, k, 2)).astype(np.float32)
    scores = rng.random((r, k)).astype(np.float32)
    valid = rng.random((r, k)) > 0.2
    thresh = [4.0, 10.0, 0.5, 0.25]   # min_radius per task (base.py:155)
    want = _jax_nms_rows(centers, scores, valid, thresh)
    np.testing.assert_array_equal(_port_nms(centers, scores, valid, thresh), want)


def test_circle_nms_identical_centres_ties_and_invalid_slots():
    centers = np.zeros((3, 6, 2), np.float32)
    centers[2, 3:] = 50.0                     # a second cluster in row 2
    # equal scores: the stable order keeps the lower slot first
    scores = np.array([[0.5, 0.9, 0.9, 0.1, 0.9, 0.3]] * 3, np.float32)
    valid = np.ones((3, 6), bool)
    valid[1, 1] = False                       # the best slot of row 1 is padding
    thresh = [1.0, 1.0, 1.0]
    got = _port_nms(centers, scores, valid, thresh)
    np.testing.assert_array_equal(got, _jax_nms_rows(centers, scores, valid, thresh))
    np.testing.assert_array_equal(got[0], [False, True, False, False, False, False])
    np.testing.assert_array_equal(got[1], [False, False, True, False, False, False])
    np.testing.assert_array_equal(got[2], [False, True, False, False, True, False])


def test_circle_nms_all_invalid_keeps_nothing():
    centers = np.random.default_rng(6).normal(size=(2, 10, 2)).astype(np.float32)
    scores = np.ones((2, 10), np.float32)
    valid = np.zeros((2, 10), bool)
    assert not _port_nms(centers, scores, valid, [1.0, 1.0]).any()


def _nms_inputs(rows, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-10, 10, (rows, k, 2)).astype(np.float32),
            rng.random((rows, k)).astype(np.float32), rng.random((rows, k)) > 0.2)


def test_circle_nms_per_task_tuple_matches_jax():
    """The decode's form: rows ordered (batch, task), one threshold a task
    given as a tuple of floats, row r using thresh[r % T]."""
    b, t, k = 3, 4, 120
    centers, scores, valid = _nms_inputs(b * t, k, seed=9)
    per_task = (4.0, 10.0, 0.5, 0.25)
    want = _jax_nms_rows(centers, scores, valid, [per_task[r % t] for r in range(b * t)])
    got = circle_nms.circle_nms_mask(torch.from_numpy(centers), torch.from_numpy(scores),
                                     torch.from_numpy(valid), per_task)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('form', ['float', 'one_tuple', 'scalar_tensor', 'row_tensor'])
def test_circle_nms_threshold_forms_match_jax(form):
    """A float, a one-element tuple, a 0-dim and an [R] tensor: each row's
    threshold is the JAX call's scalar."""
    centers, scores, valid = _nms_inputs(3, 90, seed=10)
    per_row = [2.0, 2.0, 2.0] if form != 'row_tensor' else [2.0, 6.0, 0.5]
    thresh = {'float': 2.0, 'one_tuple': (2.0,), 'scalar_tensor': torch.tensor(2.0),
              'row_tensor': torch.tensor(per_row)}[form]
    got = circle_nms.circle_nms_mask(torch.from_numpy(centers), torch.from_numpy(scores),
                                     torch.from_numpy(valid), thresh)
    np.testing.assert_array_equal(got.numpy(), _jax_nms_rows(centers, scores, valid, per_row))


def test_circle_nms_strided_centres_and_threshold_refusals():
    """Centres may be a view of the boxes (the decode passes one); per-task
    thresholds that do not divide the rows are refused."""
    rng = np.random.default_rng(11)
    boxes = torch.from_numpy(rng.uniform(-10, 10, (4, 60, 9)).astype(np.float32))
    _, scores, valid = (torch.from_numpy(a) for a in _nms_inputs(4, 60, seed=12))
    per_task = (4.0, 10.0)
    np.testing.assert_array_equal(
        circle_nms.circle_nms_mask(boxes[..., :2], scores, valid, per_task).numpy(),
        _jax_nms_rows(boxes[..., :2].numpy(), scores.numpy(), valid.numpy(), per_task * 2))
    with pytest.raises(ValueError, match='divide'):
        circle_nms.circle_nms_mask(boxes[..., :2], scores, valid, (1.0, 2.0, 3.0))


def test_decode_boxes_passes_thresholds_by_value_and_matches_jax(monkeypatch):
    """``decode_boxes`` on random head maps of ``tiny_test_config`` (4 tasks
    of 32 x 64, top 500, circle NMS with min_radius (4, 10, 0.5, 0.25))
    against the JAX decode: boxes to 1e-3, scores to 1e-4, labels and valid
    flags equal. The NMS gets the per-task thresholds as a tuple of floats
    (no tensor built per call) in one call for all (batch, task) rows."""
    import mm_training_tpu.configs as jcfg
    from mm_training_tpu.models.centerpoint_head import decode_boxes as j_decode
    import mm_training_tpu_torch.configs as tcfg
    from mm_training_tpu_torch.models import decode_boxes
    from tests.torch_port_helpers import _compare_boxes

    jconf = jcfg.tiny_test_config(use_cam=False).get_head_conf()
    tconf = tcfg.tiny_test_config(use_cam=False).get_head_conf()
    rng = np.random.default_rng(13)
    preds = []
    for task in tconf.tasks:
        p = {'heatmap': rng.normal(-1.0, 1.5, (2, 32, 64, task.num_class))}
        for name, (ch, _) in tconf.common_heads:
            p[name] = rng.normal(0.0, 0.5, (2, 32, 64, ch))
        preds.append({n: v.astype(np.float32) for n, v in p.items()})
    want = [np.asarray(a) for a in j_decode(
        jconf, [{n: jnp.asarray(v) for n, v in p.items()} for p in preds])]

    seen = []
    nms = circle_nms.circle_nms_mask

    def spy(centers, scores, valid, thresh):
        seen.append((tuple(scores.shape), thresh))
        return nms(centers, scores, valid, thresh)

    monkeypatch.setattr(circle_nms, 'circle_nms_mask', spy)
    got = [a.numpy() for a in decode_boxes(
        tconf, [{n: torch.from_numpy(v) for n, v in p.items()} for p in preds])]
    assert seen == [((8, 500), (4, 10, 0.5, 0.25))]
    _compare_boxes(got, want)


def test_batchnorm_scale_shift_follows_weight_updates():
    """s and t are cached per state of the BN tensors: an in-place update, a
    state-dict load and a dtype cast each take effect."""
    bn = BatchNorm2d(3, relu=False).eval()
    x = torch.from_numpy(_affine_inputs(shape=(1, 2, 2, 3), seed=7)[0]).permute(0, 3, 1, 2)
    y0 = bn(x)
    with torch.no_grad():
        bn.running_mean.add_(1.0)
    torch.testing.assert_close(bn(x), y0 - 1.0 / np.sqrt(1 + 1e-5))
    bn.load_state_dict({**bn.state_dict(), 'bias': torch.full((3,), 2.0)})
    torch.testing.assert_close(bn(x), y0 - 1.0 / np.sqrt(1 + 1e-5) + 2.0)
    half = bn.to(torch.bfloat16)
    assert half(x.bfloat16()).dtype == torch.bfloat16


def _head_conf_past_the_slot_limit(cfgmod, max_num=2000):
    cfg = cfgmod.tiny_test_config(use_cam=False)
    hc = cfg.get_head_conf()
    return cfg.replace(head_conf=dataclasses.replace(
        hc, bbox_coder=dataclasses.replace(hc.bbox_coder, max_num=max_num)))


def test_k3_slot_limit_is_refused_where_the_model_is_built():
    """``max_num`` = 2000 asks the card's circle NMS for more candidates a
    row than it takes (``circle_nms.MAX_SLOTS``): a model for the card is
    refused at build time, naming the knob; on the CPU it builds."""
    import mm_training_tpu_torch.configs as tcfg
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.models.bev_depth import check_card_limits
    cfg = _head_conf_past_the_slot_limit(tcfg)
    assert circle_nms.MAX_SLOTS == 1024
    with pytest.raises(ValueError, match=r'BBoxCoderConf\.max_num = 2000'):
        check_card_limits(cfg, torch.device('cuda'))
    check_card_limits(cfg, torch.device('cpu'))
    check_card_limits(_head_conf_past_the_slot_limit(tcfg, 1024), torch.device('cuda'))
    model = BEVDepthLiDAR(cfg, device='cpu')
    assert model.cfg.get_head_conf().bbox_coder.max_num == 2000


def test_decode_boxes_past_the_card_slot_limit_matches_jax():
    """On the CPU the decode takes any K, as the JAX package does: top 2000
    candidates a task (above the card's 1024), circle NMS over each row,
    against the JAX decode with the same head conf."""
    import mm_training_tpu.configs as jcfg
    from mm_training_tpu.models.centerpoint_head import decode_boxes as j_decode
    import mm_training_tpu_torch.configs as tcfg
    from mm_training_tpu_torch.models import decode_boxes
    from tests.torch_port_helpers import _compare_boxes

    jconf = _head_conf_past_the_slot_limit(jcfg).get_head_conf()
    tconf = _head_conf_past_the_slot_limit(tcfg).get_head_conf()
    rng = np.random.default_rng(17)
    preds = []
    for task in tconf.tasks:
        p = {'heatmap': rng.normal(-1.0, 1.5, (2, 32, 64, task.num_class))}
        for name, (ch, _) in tconf.common_heads:
            p[name] = rng.normal(0.0, 0.5, (2, 32, 64, ch))
        preds.append({n: v.astype(np.float32) for n, v in p.items()})
    want = [np.asarray(a) for a in j_decode(
        jconf, [{n: jnp.asarray(v) for n, v in p.items()} for p in preds])]
    got = [a.numpy() for a in decode_boxes(
        tconf, [{n: torch.from_numpy(v) for n, v in p.items()} for p in preds])]
    _compare_boxes(got, want)
