"""The training slice's pieces against the JAX package, on the CPU.

Inputs come from numpy with a seed and go through the JAX function and the
port's counterpart (the plain PyTorch versions: on the CPU each wrapper
takes its plain version):
  * K2: ``gaussian_radius`` and ``draw_heatmap`` (a centre on the map's
    edge, overlapping windows, windows clipped by the map, and the edge
    cases of the kernel's bands and staging chunks);
  * ``get_targets`` against the vmapped ``get_targets_batch``;
  * the focal and detection losses, with and without ``sample_mask``;
  * train-mode ``BatchNorm2d`` against ``flax.linen.BatchNorm``: output,
    gradients, new running statistics;
  * ``AffineAct`` (kernel A and A') against autograd of ``affine_act_plain``;
  * the optimizer against ``make_optimizer`` over three steps that cross a
    schedule boundary.
fp32 throughout; each tolerance is stated where it is asserted.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mm_training_tpu.configs as jcfg
import mm_training_tpu_torch.configs as tcfg
from mm_training_tpu.data.fake_batch import make_fake_batch as j_fake_batch
from mm_training_tpu.models import centerpoint_head as jhead
from mm_training_tpu.ops.gaussian import draw_heatmap as j_draw_heatmap
from mm_training_tpu.ops.gaussian import gaussian_radius as j_gaussian_radius
from mm_training_tpu.training.optim import make_optimizer as j_make_optimizer
from mm_training_tpu_torch.data import make_fake_batch
from mm_training_tpu_torch.exps.kernel_inputs import HEATMAP_CASES, heatmap_case
from mm_training_tpu_torch.models import centerpoint_head as head
from mm_training_tpu_torch.models.bn_fold import BatchNorm2d
from mm_training_tpu_torch.ops import affine_act, gaussian
from mm_training_tpu_torch.training import make_optimizer
from tests.torch_port_helpers import nchw, nhwc


# ------------------------------------------------------------------------ K2

def test_gaussian_radius_matches_jax():
    rng = np.random.default_rng(0)
    h = rng.uniform(0.05, 40.0, 500).astype(np.float32)
    w = rng.uniform(0.05, 40.0, 500).astype(np.float32)
    want = np.asarray(j_gaussian_radius((jnp.asarray(h), jnp.asarray(w)), 0.1))
    got = gaussian.gaussian_radius((torch.from_numpy(h), torch.from_numpy(w)), 0.1).numpy()
    # the same fp32 steps (sqrt is correctly rounded): equal to rounding
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _heatmap_case(seed=1, b=2, m=3, k=40, hw=(24, 40)):
    rng = np.random.default_rng(seed)
    h, w = hw
    centers = np.stack([rng.integers(0, w, (b, k)), rng.integers(0, h, (b, k))],
                       -1).astype(np.int32)
    centers[:, 0] = (0, 0)               # on the corner: window clipped twice
    centers[:, 1] = (w - 1, 5)           # on the right edge
    centers[:, 2:6] = centers[:, 6:7]    # four more windows on one centre
    centers[:, 7] = centers[:, 6] + 1    # a neighbour: overlapping windows
    radii = rng.integers(1, 6, (b, k)).astype(np.int32)
    radii[:, 3] = 9
    valid = rng.random((b, m, k)) < 0.6
    valid[:, :, :8] = True
    return centers, radii, valid, hw


def test_draw_heatmap_matches_jax():
    centers, radii, valid, hw = _heatmap_case()
    b, m, _ = valid.shape
    jdraw = jax.jit(j_draw_heatmap, static_argnums=3)
    want = np.stack([np.stack([np.asarray(jdraw(jnp.asarray(centers[i]), jnp.asarray(radii[i]),
                                                jnp.asarray(valid[i, j]), hw))
                               for j in range(m)]) for i in range(b)])
    before = gaussian.draw_heatmap.launches
    got = gaussian.draw_heatmap(torch.from_numpy(centers), torch.from_numpy(radii),
                                torch.from_numpy(valid), hw).numpy()
    assert gaussian.draw_heatmap.launches == before      # plain path: no launch
    assert got.shape == (b, m) + hw
    # exp of XLA and of PyTorch may differ by an ulp: 1e-6; the centres
    # (the focal loss's positives) are exactly 1.0 in both
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got == 1.0, want == 1.0)
    assert (want == 1.0).sum() > 20 and (want == 0).any()


@pytest.mark.parametrize('case', HEATMAP_CASES)
def test_draw_heatmap_edge_cases_match_jax(case):
    """The inputs the kernel's bands and staging chunks make delicate
    (``exps/kernel_inputs.py::heatmap_case``): windows across band edges,
    centres off the map, r = 0, radii larger than the map, a map with no
    valid object, more slots than one chunk, rows off 16 bytes."""
    centers, radii, valid, hw = heatmap_case(case)
    b, m, _ = valid.shape
    jdraw = jax.jit(j_draw_heatmap, static_argnums=3)
    want = np.stack([np.stack([np.asarray(jdraw(jnp.asarray(centers[i]), jnp.asarray(radii[i]),
                                                jnp.asarray(valid[i, j]), hw))
                               for j in range(m)]) for i in range(b)])
    got = gaussian.draw_heatmap(torch.from_numpy(centers), torch.from_numpy(radii),
                                torch.from_numpy(valid), hw).numpy()
    assert got.shape == (b, m) + hw
    # as above: 1e-6 for exp, the centres exactly 1.0 in both
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got == 1.0, want == 1.0)
    assert (want > 0).any()
    if case == 'no_valid_map':
        assert not got[:, 1].any()


def test_draw_heatmap_refuses_wrong_operands():
    centers, radii, valid, hw = _heatmap_case()
    with pytest.raises(ValueError, match='int32'):
        gaussian.draw_heatmap(torch.from_numpy(centers).long(), torch.from_numpy(radii),
                              torch.from_numpy(valid), hw)


# ------------------------------------------------------------------- targets

def _target_cfgs(**kw):
    return (jcfg.tiny_test_config(use_cam=False, **kw),
            tcfg.tiny_test_config(use_cam=False, **kw))


def _gt_batch(seed=3, n_objects=24, max_objs=32):
    """The JAX package's fake batch (32 object slots), plus edge cases: a
    centre at feature x = -0.5 (truncates to cell 0 and is drawn), one at
    -1.5 (off the map), a box of zero width, a class no task covers, an
    invalid slot. The configs take ``max_objs`` target slots per task."""
    jc, tc = _target_cfgs()
    jb = j_fake_batch(jc, seed=seed, n_objects=n_objects)
    tb = make_fake_batch(tc, seed=seed, n_objects=n_objects)
    jc, tc = _target_cfgs(max_objs=max_objs)
    for key in ('gt_boxes', 'gt_labels', 'gt_mask'):
        np.testing.assert_array_equal(tb[key], jb[key])
    boxes, labels, mask = jb['gt_boxes'].copy(), jb['gt_labels'].copy(), jb['gt_mask'].copy()
    tr = jc.get_head_conf().train_cfg
    cell = tr.voxel_size[0] * tr.out_size_factor
    boxes[:, 0, 0] = tr.point_cloud_range[0] - 0.5 * cell       # feature x = -0.5
    boxes[:, 1, 0] = tr.point_cloud_range[0] - 1.5 * cell       # feature x = -1.5
    boxes[:, 2, 3] = 0.0                                        # no width
    labels[:, 3] = 4                                            # no task draws class 4
    mask[:, 4] = False
    return jc, tc, boxes, labels, mask


def _jax_targets(jc, boxes, labels, mask):
    out = jhead.get_targets_batch(jc.get_head_conf(), jnp.asarray(boxes),
                                  jnp.asarray(labels), jnp.asarray(mask))
    return jax.tree_util.tree_map(np.asarray, out)


def _port_targets(tc, boxes, labels, mask):
    return head.get_targets(tc.get_head_conf(), torch.from_numpy(boxes),
                            torch.from_numpy(labels), torch.from_numpy(mask))


@pytest.mark.parametrize('max_objs', [32, 5])
def test_get_targets_matches_jax(max_objs):
    """max_objs=5: most tasks have more objects than slots, so the cumsum
    slot order and the dump slot are exercised."""
    jc, tc, boxes, labels, mask = _gt_batch(max_objs=max_objs)
    want = _jax_targets(jc, boxes, labels, mask)
    got = _port_targets(tc, boxes, labels, mask)
    for t in range(len(tc.get_head_conf().tasks)):
        hm, wh = got[0][t].numpy(), want[0][t]
        assert hm.shape == wh.shape
        np.testing.assert_allclose(hm, wh, rtol=0, atol=1e-6)   # exp: an ulp at most
        np.testing.assert_array_equal(hm == 1.0, wh == 1.0)
        # slots, cells and masks are exact; the box targets are the same fp32
        # steps, but log/sin/cos of XLA and PyTorch may differ by an ulp
        np.testing.assert_array_equal(got[2][t].numpy(), want[2][t])
        np.testing.assert_array_equal(got[3][t].numpy(), want[3][t])
        np.testing.assert_allclose(got[1][t].numpy(), want[1][t], rtol=1e-6, atol=1e-6)
    # the edge cases took effect: the x = -0.5 object is drawn at column 0,
    # and with 5 slots the larger tasks fill all of theirs
    assert sum((w[0, ..., 0] == 1.0).sum() for w in want[0]) >= 1
    fill = max(w.sum(1).max() for w in want[3])
    assert fill == 5 if max_objs == 5 else fill > 5


def test_heatmap_inputs_are_the_targets_kernel_operands():
    jc, tc, boxes, labels, mask = _gt_batch()
    conf = tc.get_head_conf()
    centers, radii, valid, hw = head.heatmap_inputs(
        conf, torch.from_numpy(boxes), torch.from_numpy(labels), torch.from_numpy(mask))
    maps = gaussian.draw_heatmap_plain(centers, radii, valid, hw)
    want = _jax_targets(jc, boxes, labels, mask)[0]
    np.testing.assert_allclose(maps.numpy(), np.concatenate(want, axis=1), rtol=0, atol=1e-6)


# -------------------------------------------------------------------- losses

def _preds(conf, b, hw, seed):
    rng = np.random.default_rng(seed)
    out = []
    for task in conf.tasks:
        heads = dict(conf.common_heads, heatmap=(task.num_class, 2))
        out.append({name: rng.normal(0, 1.5, (b,) + hw + (ch,)).astype(np.float32)
                    for name, (ch, _) in heads.items()})
    return out


@pytest.mark.parametrize('sample_mask', [None, (True, False)])
def test_detection_loss_matches_jax(sample_mask):
    jc, tc, boxes, labels, mask = _gt_batch()
    tr = tc.get_head_conf().train_cfg
    hw = (tr.grid_size[1] // tr.out_size_factor, tr.grid_size[0] // tr.out_size_factor)
    preds = _preds(tc.get_head_conf(), boxes.shape[0], hw, seed=5)
    targets = _jax_targets(jc, boxes, labels, mask)
    sm = None if sample_mask is None else np.asarray(sample_mask)
    want = float(jhead.detection_loss(
        jc.get_head_conf(), jax.tree_util.tree_map(jnp.asarray, targets),
        jax.tree_util.tree_map(jnp.asarray, preds),
        sample_mask=None if sm is None else jnp.asarray(sm)))
    got = float(head.detection_loss(
        tc.get_head_conf(), jax.tree_util.tree_map(lambda a: torch.tensor(np.array(a)), targets),
        jax.tree_util.tree_map(torch.from_numpy, preds),
        sample_mask=None if sm is None else torch.from_numpy(sm)))
    assert want > 1.0
    assert abs(got - want) <= 1e-5 * abs(want)       # fp32 sums in another order


def test_gaussian_focal_loss_matches_jax():
    rng = np.random.default_rng(6)
    pred = rng.uniform(1e-4, 1 - 1e-4, (2, 16, 24, 3)).astype(np.float32)
    target = rng.uniform(0, 1, pred.shape).astype(np.float32) ** 4
    target[:, ::5, ::7] = 1.0
    want = float(jhead.gaussian_focal_loss(jnp.asarray(pred), jnp.asarray(target), 7.0))
    got = float(head.gaussian_focal_loss(torch.from_numpy(pred), torch.from_numpy(target), 7.0))
    assert abs(got - want) <= 1e-5 * abs(want)


# --------------------------------------------------------------- train-mode BN

@pytest.mark.parametrize('relu,with_residual', [(True, False), (False, False), (True, True)])
def test_batchnorm_train_mode_matches_flax(relu, with_residual):
    rng = np.random.default_rng(7)
    x = rng.normal(0.3, 2.0, (2, 6, 10, 24)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    c = x.shape[-1]
    params = {'scale': rng.normal(1, 0.2, c).astype(np.float32),
              'bias': rng.normal(0, 0.2, c).astype(np.float32)}
    stats = {'mean': rng.normal(0, 0.5, c).astype(np.float32),
             'var': rng.uniform(0.5, 1.5, c).astype(np.float32)}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)

    def f(x, p):
        y, new = bn.apply({'params': p, 'batch_stats': stats}, x, mutable=['batch_stats'])
        if with_residual:
            y = y + r
        return (jnp.maximum(y, 0.0) if relu else y), new['batch_stats']

    want, vjp, new_stats = jax.vjp(f, jnp.asarray(x), params, has_aux=True)
    dx_want, dp_want = vjp(jnp.asarray(cot))

    mod = BatchNorm2d(c, relu=relu).train()
    with torch.no_grad():
        for name, v in (('weight', params['scale']), ('bias', params['bias']),
                        ('running_mean', stats['mean']), ('running_var', stats['var'])):
            getattr(mod, name).copy_(torch.from_numpy(v))
    xt = nchw(x).requires_grad_(True)
    rt = nchw(r).requires_grad_(True) if with_residual else None
    y = mod(xt, rt)
    y.backward(nchw(cot))
    # fp32: x*s + (b - mean*s) against (x - mean)*s + b, and the statistics'
    # gradient summed in another order
    np.testing.assert_allclose(nhwc(y), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(dx_want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mod.weight.grad.numpy(), np.asarray(dp_want['scale']),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mod.bias.grad.numpy(), np.asarray(dp_want['bias']),
                               rtol=1e-4, atol=1e-4)
    if with_residual:
        np.testing.assert_allclose(nhwc(rt.grad), cot * (np.asarray(want) > 0), atol=0)
    np.testing.assert_allclose(mod.running_mean.numpy(), np.asarray(new_stats['mean']),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mod.running_var.numpy(), np.asarray(new_stats['var']),
                               rtol=1e-5, atol=1e-6)
    assert int(mod.num_batches_tracked) == 0      # flax has no such counter


# ------------------------------------------------------------------ kernel A'

@pytest.mark.parametrize('relu', [True, False])
@pytest.mark.parametrize('with_residual', [False, True])
def test_affine_act_gradients_match_autograd_of_plain(relu, with_residual):
    rng = np.random.default_rng(8)
    shape, c = (2, 5, 7, 16), 16

    def leaf(a):
        return torch.from_numpy(a.astype(np.float32)).requires_grad_(True)
    x = leaf(rng.normal(size=shape)).permute(0, 3, 1, 2)
    r = leaf(rng.normal(size=shape)).permute(0, 3, 1, 2) if with_residual else None
    s, t = leaf(rng.normal(size=c)), leaf(rng.normal(size=c))
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).permute(0, 3, 1, 2)
    inputs = [v for v in (x, s, t, r) if v is not None]

    before = affine_act.affine_act_backward.launches
    got_y = affine_act.AffineAct.apply(x, s, t, r, relu)
    got = torch.autograd.grad(got_y, inputs, g)
    want_y = affine_act.affine_act_plain(x, s, t, r, relu)
    want = torch.autograd.grad(want_y, inputs, g)
    assert affine_act.affine_act_backward.launches == before   # plain path on the CPU
    torch.testing.assert_close(got_y, want_y, rtol=0, atol=0)
    # dx, dr: one product each, equal; ds, dt: fp32 sums in another order
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
    if with_residual:
        torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)


def test_batchnorm_eval_mode_passes_input_gradients():
    """Eval mode with gradients on goes through AffineAct too, so the graph
    is not cut below a frozen BatchNorm."""
    bn = BatchNorm2d(4, relu=True).eval()
    x = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    bn(x).sum().backward()
    s, t = bn.scale_shift()
    want = (x.detach() * s.view(1, 4, 1, 1) + t.view(1, 4, 1, 1) > 0) * s.view(1, 4, 1, 1)
    torch.testing.assert_close(x.grad, want)


# ----------------------------------------------------------------- optimizer

def test_optimizer_matches_optax_across_a_schedule_boundary():
    """Three steps, milestone at step 2 (lr x 0.1 from there); the first
    gradients are large enough to be clipped, the others not."""
    jc, tc = _target_cfgs(lr_milestones=(2,))
    rng = np.random.default_rng(9)
    shapes = {'a': (3, 4), 'b': (7,), 'c': (2, 2, 3)}
    params = {k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(0, scale, s)).astype(np.float32) for k, s in shapes.items()}
             for scale in (5.0, 0.1, 0.2)]
    tx = j_make_optimizer(jc, steps_per_epoch=1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in sorted(shapes)]
    opt = make_optimizer(tc, tp, steps_per_epoch=1)
    lr = tc.learning_rate
    for i, g in enumerate(grads):
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        upd, opt_state = tx.update(jg, opt_state, jp)
        new_jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        old = [p.clone() for p in tp]
        norm = opt.step([torch.from_numpy(g[k]) for k in sorted(shapes)])
        want_norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))
        assert abs(float(norm) - want_norm) <= 1e-6 * want_norm
        step_lr = lr * (0.1 if i >= 2 else 1.0)
        for k, p, p0 in zip(sorted(shapes), tp, old):
            want_u = np.asarray(new_jp[k]) - np.asarray(jp[k])
            # each update is about lr * sign(g); the same fp32 steps in
            # another order agree to 1e-4 of it
            np.testing.assert_allclose((p - p0).numpy(), want_u, rtol=0,
                                       atol=1e-4 * step_lr)
            np.testing.assert_allclose(p.numpy(), np.asarray(new_jp[k]), rtol=0, atol=1e-7)
        jp = new_jp
    assert opt.count == 3
    # the boundary took effect: the last step moved by ~0.1 lr per element
    assert np.abs(want_u).max() <= 0.11 * lr
