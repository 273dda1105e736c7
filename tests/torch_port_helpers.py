"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Random flax variables are filled from numpy with a seed (every kernel,
bias, BN scale and running statistic random, so eval-mode parity exercises
each conversion rule), without running flax's init.
"""
import dataclasses
import functools

import jax
import numpy as np
import torch


def random_variables(init_fn, *args, seed: int = 0):
    """{'params', 'batch_stats'} of ``init_fn(rng, *args)``'s shapes (array
    arguments only; ``train`` keeps its default False), filled from
    ``np.random.default_rng(seed)``."""
    shapes = jax.eval_shape(functools.partial(init_fn, jax.random.PRNGKey(0)),
                            *args)
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name, shape = path[-1].key, sd.shape
        if name == 'kernel':
            v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == 'scale':
            v = rng.normal(1.0, 0.2, shape)
        elif name == 'var':
            v = rng.uniform(0.5, 1.5, shape)
        elif name == 'mean':
            v = rng.normal(0.0, 0.5, shape)
        else:  # conv and BN biases
            v = rng.normal(0.0, 0.2, shape)
        return v.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(leaf, shapes)
    return {'params': v['params'], 'batch_stats': v.get('batch_stats', {})}


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the port's NCHW (channels_last) view of the same data."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def nhwc(x_nchw: torch.Tensor) -> np.ndarray:
    return x_nchw.permute(0, 2, 3, 1).detach().numpy()


def narrow(cfgmod, cfg):
    """``cfg`` with narrow lidar-encoder and head-trunk/neck widths (same
    structure). ``cfgmod`` is either package's ``configs`` module: the two
    share their dataclass and field names."""
    lconf = dataclasses.replace(
        cfg.get_lidar_conf(),
        encoder_channels=((8, 8, 16), (16, 16, 32), (32, 32, 64), (64, 64)),
        out_channels=64)
    head = dataclasses.replace(
        cfg.get_head_conf(),
        bev_backbone_conf=cfgmod.BEVBackboneConf(in_channels=64, base_channels=32),
        bev_neck_conf=cfgmod.BEVNeckConf(in_channels=(32, 64, 128),
                                         out_channels=(16, 16, 16)),
        in_channels=48)
    return cfg.replace(lidar_conf=lconf, head_conf=head)


def narrow_cam(cfgmod, cfg):
    """:func:`narrow` plus a narrow camera branch: image ResNet-10, DepthNet
    ``mid_channels`` 32; the head trunk takes what the fuse layer (or the
    camera BEV alone) emits."""
    out = narrow(cfgmod, cfg)
    bb = dataclasses.replace(
        cfg.get_backbone_conf(), img_backbone_conf=cfgmod.ImageBackboneConf(depth=10),
        depth_net_conf=cfgmod.DepthNetConf(in_channels=512, mid_channels=32))
    head = out.get_head_conf()
    cin = cfg.fuse_layer_in_channels if cfg.use_lidar else cfg.camera_feature_channels
    head = dataclasses.replace(head, bev_backbone_conf=dataclasses.replace(
        head.bev_backbone_conf, in_channels=cin))
    return out.replace(backbone_conf=bb, head_conf=head)


def raw_rig(cfg):
    """``cfg`` (either package's) with the general lift-splat:
    ``BackboneConf.factorized_splat=False``."""
    return cfg.replace(backbone_conf=dataclasses.replace(cfg.get_backbone_conf(),
                                                         factorized_splat=False))


def _compare_boxes(got, want) -> None:
    """Valid flags and labels equal, scores within 1e-4 and each kept box
    within 1e-3 (m, rad, m/s), more than 50 kept boxes compared. Two kept
    boxes whose scores tie to rounding may trade slots, so a box is looked
    up among the kept boxes of its row with the same label and score."""
    (gb, gs, gl, gv), (wb, ws, wl, wv) = got, want
    assert gb.shape == wb.shape == (2, 4 * 83, 9)
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() > 50                       # the comparison has substance
    np.testing.assert_array_equal(gl[wv], wl[wv])
    np.testing.assert_allclose(gs, ws, atol=1e-4)
    for b, i in zip(*np.nonzero(wv)):
        same = gv[b] & (gl[b] == wl[b, i]) & (np.abs(gs[b] - ws[b, i]) <= 1e-4)
        err = np.abs(gb[b, same] - wb[b, i]).max(-1)
        assert err.min() <= 1e-3, (b, i, gb[b, i], wb[b, i])


def check_camera_predict_parity(use_radar: bool, use_depth_loss: bool,
                                rotated_bda: bool, seed: int = 4,
                                pitch_deg: float = 0.0) -> None:
    """The port's predict step against the JAX package's on
    ``tiny_test_config(use_cam=True)`` (camera + LiDAR, 2 cameras of 64 x
    128, 50 depth bins) at narrow widths, fp32, with random flax variables
    carried over by ``state_dict_from_flax`` (the DCN's offset conv random
    too, so the deformable taps leave the pixel grid) and the tolerances of
    :func:`check_predict_parity`. ``rotated_bda`` replaces the identity
    ``bda_mat`` with the port's ``random_bda_matrices``; with ``use_depth_loss`` the
    LiDAR depth labels replace the predicted depth in the lift. A nonzero
    ``pitch_deg`` pitches the fake rig's cameras (``make_fake_batch``) and
    builds both models with the general splat (:func:`raw_rig`), the raw-rig
    path."""
    import jax.numpy as jnp

    import mm_training_tpu.configs as jcfg
    from mm_training_tpu.data.fake_batch import make_fake_batch as j_fake_batch
    from mm_training_tpu.models import BEVDepthLiDAR as JModel
    from mm_training_tpu.training.train_step import TrainState
    from mm_training_tpu.training.train_step import make_predict_step as j_predict
    import mm_training_tpu_torch.configs as tcfg
    from mm_training_tpu_torch.data import make_fake_batch, random_bda_matrices
    from mm_training_tpu_torch.models import BEVDepthLiDAR, state_dict_from_flax
    from mm_training_tpu_torch.training import make_predict_step

    kw = dict(use_cam=True, use_radar=use_radar, use_depth_loss=use_depth_loss)
    jc = narrow_cam(jcfg, jcfg.tiny_test_config(**kw))
    tc = narrow_cam(tcfg, tcfg.tiny_test_config(**kw))
    jbatch = j_fake_batch(jc, seed=3)
    batch = make_fake_batch(tc, seed=3)
    assert set(batch) == set(jbatch)
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
    if pitch_deg:
        jc, tc = raw_rig(jc), raw_rig(tc)
        batch = make_fake_batch(tc, seed=3, pitch_deg=pitch_deg)
        jbatch.update({k: batch[k].copy() for k in ('sensor2ego', 'extrinsics')})
    if rotated_bda:
        batch['bda_mat'] = jbatch['bda_mat'] = random_bda_matrices(2, seed=5)

    jm = JModel(jc)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    v = random_variables(jm.init, dict(jb, flipped=jnp.zeros((2 * jc.num_cameras,), bool)),
                         seed=seed)
    want = [np.asarray(a) for a in j_predict(jc, jm)(
        TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                   batch_stats=v['batch_stats'], opt_state=None), jb)]

    model = BEVDepthLiDAR(tc, device='cpu')
    model.load_state_dict(state_dict_from_flax(v['params'], v['batch_stats'], tc))
    _compare_boxes([a.numpy() for a in make_predict_step(tc, model)(batch)], want)


def check_predict_parity(use_radar: bool) -> None:
    """The port's predict step against the JAX package's ``make_predict_step``
    on ``tiny_test_config(use_cam=False)`` at narrow widths, fp32.

    Random flax variables are carried over by ``state_dict_from_flax``; the
    request batch comes from both packages' ``make_fake_batch``. Boxes are
    compared by :func:`_compare_boxes`
    (tests/test_models/test_full_pipeline_parity.py's tolerances)."""
    import jax.numpy as jnp

    import mm_training_tpu.configs as jcfg
    from mm_training_tpu.data.fake_batch import make_fake_batch as j_fake_batch
    from mm_training_tpu.models import BEVDepthLiDAR as JModel
    from mm_training_tpu.training.train_step import TrainState
    from mm_training_tpu.training.train_step import make_predict_step as j_predict
    import mm_training_tpu_torch.configs as tcfg
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.models import BEVDepthLiDAR, state_dict_from_flax
    from mm_training_tpu_torch.training import make_predict_step

    jc = narrow(jcfg, jcfg.tiny_test_config(use_cam=False, use_radar=use_radar))
    tc = narrow(tcfg, tcfg.tiny_test_config(use_cam=False, use_radar=use_radar))
    jbatch = j_fake_batch(jc, seed=3)
    batch = make_fake_batch(tc, seed=3)
    for k in ('points', 'point_mask'):
        np.testing.assert_array_equal(batch[k], jbatch[k])

    jm = JModel(jc)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    model_batch = dict(jb, flipped=jnp.zeros((jc.batch_size,), bool))
    v = random_variables(jm.init, model_batch, seed=4)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                       batch_stats=v['batch_stats'], opt_state=None)
    want = [np.asarray(a) for a in j_predict(jc, jm)(state, jb)]

    model = BEVDepthLiDAR(tc, device='cpu')
    model.load_state_dict(state_dict_from_flax(v['params'], v['batch_stats'], tc))
    _compare_boxes([a.numpy() for a in make_predict_step(tc, model)(batch)], want)


# The one parameter whose exact gradient is zero on both sides and is left
# out of the gradient comparison: the port's shared-conv bias (the flax
# ConvBN has none; weights.py carries zeros) sits right before a train-mode
# BatchNorm, which subtracts it again. Each framework's value is rounding
# residue, which Adam's first step scales up to about lr. (The JAX package's
# SeparateHead branch convs carry such biases too; the port folds them into
# the BN running mean and has no parameter for them.)
ZERO_GRAD_BIASES = ('head.shared_conv.conv.bias',)


def train_parity_case(use_radar: bool, dtype=np.float32, use_ema: bool = False,
                      lidar_variant: str = 'dense') -> dict:
    """One train step of both packages on ``tiny_test_config(use_cam=False)``
    at narrow widths from the same random flax variables (carried over by
    ``state_dict_from_flax``) and the same fake batch, with the weights in
    ``dtype``; in float32 also one eval step on the batch padded with
    ``sample_valid`` [True, False]. Returns what the checks below compare.

    Why float64 too: at a random init the heatmap loss pushes every logit
    the same way, so the gradient reaching each train-mode BatchNorm is
    nearly constant over (N, H, W), and BN's backward subtracts its mean.
    That difference of near-equal sums turns float32 rounding (sums taken
    in another order, flax's one-pass variance E[x^2] - E[x]^2 against
    ``var_mean``) into gradient differences of up to ~10% of a tensor's
    largest entry, in either package alike. In float64 (JAX with x64, the
    port's plain versions computing in float64) the same step agrees to
    ~1e-7, the float32 heatmap targets' rounding; that is where the
    gradients and the update are held to their tolerances.

    With ``use_ema`` both configs take ``use_ema=True``, and the result also
    holds each package's EMA shadow after the step (``j_ema``, ``p_ema``),
    the JAX running statistics folded with the step's input biases as
    ``j_stats`` are. ``lidar_variant='sparse_import'`` runs both packages'
    sparse-import LiDAR encoder (its exact point cap on)."""
    import jax.numpy as jnp

    import mm_training_tpu.configs as jcfg
    from mm_training_tpu.data.fake_batch import make_fake_batch as j_fake_batch
    from mm_training_tpu.models import BEVDepthLiDAR as JModel
    from mm_training_tpu.training.optim import make_optimizer as j_make_optimizer
    from mm_training_tpu.training.train_step import TrainState as JState
    from mm_training_tpu.training.train_step import make_eval_step as j_eval_step
    from mm_training_tpu.training.train_step import make_train_step as j_train_step
    import mm_training_tpu_torch.configs as tcfg
    from mm_training_tpu_torch.data import make_fake_batch
    from mm_training_tpu_torch.models import BEVDepthLiDAR, state_dict_from_flax
    from mm_training_tpu_torch.training import (create_train_state, make_eval_step,
                                                make_train_step)

    kw = dict(use_cam=False, use_radar=use_radar, use_ema=use_ema)
    jc = narrow(jcfg, jcfg.tiny_test_config(**kw))
    tc = narrow(tcfg, tcfg.tiny_test_config(**kw))
    jc, tc = (c.replace(lidar_conf=dataclasses.replace(c.get_lidar_conf(), variant=lidar_variant))
              for c in (jc, tc))
    jbatch = j_fake_batch(jc, seed=3)
    batch = make_fake_batch(tc, seed=3)
    for k in batch:
        if k in jbatch:
            np.testing.assert_array_equal(batch[k], jbatch[k])
    jm = JModel(jc)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    v = random_variables(jm.init, dict(jb, flipped=jnp.zeros((jc.batch_size,), bool)),
                         seed=4)
    v = jax.tree_util.tree_map(lambda a: a.astype(dtype), v)
    fp64 = dtype == np.float64
    x64 = jax.config.jax_enable_x64
    jax.config.update('jax_enable_x64', fp64)
    try:
        tx = j_make_optimizer(jc, steps_per_epoch=10)
        jstate = JState(step=jnp.zeros((), jnp.int32), params=v['params'],
                        batch_stats=v['batch_stats'], opt_state=tx.init(v['params']),
                        ema_params=v['params'] if use_ema else None,
                        ema_batch_stats=v['batch_stats'] if use_ema else None)
        j_eval = None
        if not fp64:
            pad = jnp.asarray([True, False])
            j_eval = jax.tree_util.tree_map(
                np.asarray, j_eval_step(jc, jm)(jstate, dict(jb, sample_valid=pad))[:2])
        new, j_met = j_train_step(jc, jm, tx)(jstate, jb, jax.random.PRNGKey(0))
        j_met = {k: float(x) for k, x in j_met.items()}
        ema = (new.ema_params, new.ema_batch_stats) if use_ema else None
        new, ema = jax.tree_util.tree_map(np.asarray, ((new.params, new.batch_stats,
                                                        new.opt_state[1][0].mu), ema))
    finally:
        jax.config.update('jax_enable_x64', x64)
    new_params, new_stats, new_mu = new

    def carry(params, stats):
        return {k: t.numpy() for k, t in state_dict_from_flax(params, stats, tc).items()}

    model = BEVDepthLiDAR(tc, device='cpu').to(torch.float64 if fp64 else torch.float32)
    model.load_state_dict(state_dict_from_flax(v['params'], v['batch_stats'], tc))
    state = create_train_state(tc, model, steps_per_epoch=10)
    p_eval = None
    if not fp64:
        p_eval = make_eval_step(tc)(state, dict(batch, sample_valid=np.array([True, False])))
        p_eval = jax.tree_util.tree_map(lambda t: t.numpy(), p_eval[:2])
    old = {n: p.detach().clone().numpy() for n, p in model.named_parameters()}
    state, p_met = make_train_step(tc)(state, batch)
    names = [n for n, _ in model.named_parameters()]
    return {
        'lr': tc.learning_rate,
        'j_metrics': j_met,
        'p_metrics': {k: float(x) for k, x in p_met.items()},
        # Adam's first moment after one step is 0.1 x the clipped gradient
        'j_mu': carry(new_mu, v['batch_stats']),
        'p_mu': {n: m.numpy() for n, m in zip(names, state.optimizer.mu)},
        'j_old': carry(v['params'], v['batch_stats']),
        'j_new': carry(new_params, v['batch_stats']),
        'p_old': old,
        'p_new': {n: p.detach().numpy() for n, p in model.named_parameters()},
        # new statistics folded with the step's input biases: the batch mean
        # the JAX step took included them (see ZERO_GRAD_BIASES)
        'j_stats': carry(v['params'], new_stats),
        'p_stats': {n: b.numpy() for n, b in model.named_buffers()},
        'j_eval': j_eval,
        'p_eval': p_eval,
        'j_ema': None if ema is None else dict(carry(ema[0], v['batch_stats']),
                                               **{k: a for k, a in carry(v['params'], ema[1]).items()
                                                  if k.endswith(('running_mean', 'running_var'))}),
        'p_ema': None if state.ema is None else {k: t.numpy() for k, t in state.ema.items()},
    }


# The camera's zero-gradient biases (see ZERO_GRAD_BIASES): the reduce
# conv's bias (the reference's; flax's ConvBN has none and weights.py
# carries zeros) feeds a train-mode BatchNorm right away.
CAMERA_ZERO_GRAD_BIASES = ('backbone.depth_net.reduce_conv.0.bias',)


def _record_bernoulli(draws: dict):
    """A ``jax.random.bernoulli`` that also records each draw's value, in
    the order the traced program makes them, into ``draws`` (index -> numpy
    array) through ``jax.debug.callback``, so a jitted step hands its own
    random bits to the test."""
    orig = jax.random.bernoulli
    counter = [0]

    def store(i, value):
        draws[i] = np.asarray(value)

    def bernoulli(key, p=0.5, shape=None):
        out = orig(key, p, shape)
        jax.debug.callback(functools.partial(store, counter[0]), out)
        counter[0] += 1
        return out
    return bernoulli


def _true_division_normalize(imgs):
    """The JAX package's ``normalize_images`` (train_step.py:74-81) with its
    divisors behind an optimization barrier. Under ``jit`` on the CPU, XLA
    rewrites its divisions by the constants 255 and the std into
    multiplies by their reciprocals (with the mean's subtraction fused),
    which moves about three quarters of the normalised values by a float32
    ulp against the true divisions the source writes (eager JAX and the
    port compute those). The barrier keeps them divisions, bit for bit
    with eager JAX."""
    import jax.numpy as jnp
    from mm_training_tpu.training.train_step import IMAGENET_MEAN, IMAGENET_STD
    bar = jax.lax.optimization_barrier
    x = imgs[..., :3].astype(jnp.float32) / bar(jnp.float32(255.0))
    return ((x - bar(jnp.asarray(IMAGENET_MEAN, x.dtype)))
            / bar(jnp.asarray(IMAGENET_STD, x.dtype)))


def camera_train_parity_case(use_radar: bool = False, use_lidar: bool = True,
                             use_depth_loss: bool = True, num_sweeps: int = 1,
                             dtype=np.float32, with_eval: bool = True,
                             rotated_bda: bool = True, pitch_deg: float = 0.0,
                             config_fn=None, batch_fn=None) -> dict:
    """One camera train step of both packages on ``tiny_test_config(
    use_cam=True)`` at narrow widths (:func:`narrow_cam`: 2 cameras of 64 x
    128, 50 depth bins, ResNet-10, DepthNet mid 32) from the same random
    flax variables (the DCN's offset conv random too, so the taps sample
    between pixels), the same fake batch with a rotated, flipped and scaled
    BEV augmentation, and the JAX step's own random draws; in float32 also
    one eval step on the batch padded with ``sample_valid`` [True, False].
    Returns what :func:`train_parity_case` returns, plus both eval steps'
    depth viz and the flip mask.

    The random draws. The JAX step flips each of the B*S*N images with
    ``bernoulli(split(fold_in(rng, step))[0], 0.5)`` (its train_step.py:197
    and :124) and draws ASPP's dropout masks from the other half of that
    split (one a sweep). A recording ``jax.random.bernoulli`` hands both to
    the test from inside the jitted step (:func:`_record_bernoulli`); the
    flip mask is also recomputed here from that key path and must agree.
    The rng key is the first one from 0 on whose flips mark some images and
    leave others, so both branches of the flip run. The port takes the same
    masks as its step's ``draws``; dropout runs on both sides. The JAX steps
    are traced with :func:`_true_division_normalize` in place of their
    ``normalize_images``: a float32 ulp in the images moves the float64
    gradients by up to ~1% of a tensor's largest entry (measured: the
    train-mode BatchNorms' cancellation amplifies it, as in the float32
    step), so the images must agree bit for bit; the source's arithmetic
    is kept, XLA's rewrite of it is not.

    Where each package rounds to float32, also in the float64 run (JAX with
    x64 switched on for the fixture only, the port's plain versions in
    float64):
      * the splat's einsum over image rows (JAX ``preferred_element_type=
        jnp.float32``, ops/voxel_pooling.py:160) is computed in float64 and
        its result rounded to float32, then segment-summed in float32 and
        cast back; the port's plain version computes the einsum in the
        promoted dtype, rounds to float32 and ``index_add_``s in float32;
      * the DCN's grouped einsum (depth_net.py:108, ``preferred_element_type
        =jnp.float32``) likewise: the port's ``bmm`` in float64, rounded to
        float32, then back to float64;
      * the DCN's offsets (``offsets.astype(jnp.float32)``, :54): both
        sample with float32 coordinates and corner weights, the weights
        then taken back to x's float64;
      * the depth prediction before the loss (``depth_pred.astype(
        jnp.float32)``, train_step.py:231), and the labels, are float32:
        the depth loss and its gradient are float32 computations in both;
      * the BEV warp blends in float64 in both (fp32 coordinates).
    The backward passes round at the transposes of the same casts. So the
    float64 step differs between the packages by float32 roundings taken
    in other orders (the loss's sums) where it differs at all: measured,
    the float64 gradients agree within 5e-7 of each tensor's largest entry
    in every camera configuration, the lidar step's agreement, so they are
    held to the lidar step's tolerances (:func:`check_train_gradients`,
    1e-4 of each tensor's largest entry, and the others below).

    A nonzero ``pitch_deg`` pitches the fake rig's cameras and builds both
    models with the general splat (:func:`raw_rig`): the raw-rig path, whose
    splat rounds each product to the compute dtype and sums the cells in
    float32 in both packages (also in the float64 run).

    ``rotated_bda`` replaces the fake batch's identity BEV augmentation with
    ``random_bda_matrices``. The float32 step takes it; the float64 step
    keeps the identity: under a rotation the JAX warp's LU inverse
    (``jnp.linalg.inv``, float32) and the port's closed-form one differ by
    float32 ulps, both correct inverses (``test_torch_camera_ops.py``),
    which move the sample points, and the amplification above turns that
    into float64 gradient differences of up to ~5% of a tensor's largest
    entry (measured). The rotated warp's gradient is held against
    ``jax.vjp`` on its own (``test_torch_camera_grads.py``).

    ``config_fn(cfgmod, cfg)``, when given, changes both packages' configs
    after :func:`narrow_cam` (``cfgmod`` is each package's ``configs``);
    ``batch_fn(jc, tc)`` gives (JAX batch, port batch) in place of the fake
    batches (the nuScenes slice's dataset batches)."""
    import jax.numpy as jnp

    import mm_training_tpu.configs as jcfg
    from mm_training_tpu.data.fake_batch import make_fake_batch as j_fake_batch
    from mm_training_tpu.models import BEVDepthLiDAR as JModel
    from mm_training_tpu.training import train_step as j_steps
    from mm_training_tpu.training.optim import make_optimizer as j_make_optimizer
    from mm_training_tpu.training.train_step import TrainState as JState
    from mm_training_tpu.training.train_step import make_eval_step as j_eval_step
    from mm_training_tpu.training.train_step import make_train_step as j_train_step
    import mm_training_tpu_torch.configs as tcfg
    from mm_training_tpu_torch.data import make_fake_batch, random_bda_matrices
    from mm_training_tpu_torch.models import BEVDepthLiDAR, state_dict_from_flax
    from mm_training_tpu_torch.training import (create_train_state, make_eval_step,
                                                make_train_step)

    kw = dict(use_cam=True, use_lidar=use_lidar, use_radar=use_radar and use_lidar,
              use_depth_loss=use_depth_loss, num_sweeps=num_sweeps)
    jc = narrow_cam(jcfg, jcfg.tiny_test_config(**kw))
    tc = narrow_cam(tcfg, tcfg.tiny_test_config(**kw))
    if config_fn is not None:
        jc, tc = config_fn(jcfg, jc), config_fn(tcfg, tc)
    if batch_fn is not None:
        jbatch, batch = batch_fn(jc, tc)
    else:
        jbatch = j_fake_batch(jc, seed=3)
        batch = make_fake_batch(tc, seed=3)
    for k in batch:
        if k in jbatch:
            np.testing.assert_array_equal(batch[k], jbatch[k])
    if pitch_deg:
        jc, tc = raw_rig(jc), raw_rig(tc)
        batch = make_fake_batch(tc, seed=3, pitch_deg=pitch_deg)
        jbatch.update({k: batch[k].copy() for k in ('sensor2ego', 'extrinsics')})
    if rotated_bda:
        batch['bda_mat'] = jbatch['bda_mat'] = random_bda_matrices(2, seed=5)
    b, s, n = batch['imgs'].shape[:3]
    jm = JModel(jc)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    v = random_variables(jm.init, dict(jb, flipped=jnp.zeros((b * s * n,), bool)), seed=4)
    v = jax.tree_util.tree_map(lambda a: a.astype(dtype), v)
    fp64 = dtype == np.float64
    x64 = jax.config.jax_enable_x64
    jax.config.update('jax_enable_x64', fp64)
    draws = {}
    normalize = j_steps.normalize_images
    j_steps.normalize_images = _true_division_normalize
    try:
        for seed in range(100):
            rng = jax.random.PRNGKey(seed)
            rng_flip = jax.random.split(jax.random.fold_in(rng, 0))[0]
            flips = np.asarray(jax.random.bernoulli(rng_flip, 0.5, (b * s * n,)))
            if flips.any() and not flips.all():
                break
        tx = j_make_optimizer(jc, steps_per_epoch=10)
        jstate = JState(step=jnp.zeros((), jnp.int32), params=v['params'],
                        batch_stats=v['batch_stats'], opt_state=tx.init(v['params']))
        j_eval = None
        if with_eval and not fp64:
            pad = jnp.asarray([True, False])
            j_eval = jax.tree_util.tree_map(
                np.asarray, j_eval_step(jc, jm)(jstate, dict(jb, sample_valid=pad)))
        bernoulli = jax.random.bernoulli
        jax.random.bernoulli = _record_bernoulli(draws)
        try:
            new, j_met = j_train_step(jc, jm, tx)(jstate, jb, rng)
            j_met = {k: float(x) for k, x in j_met.items()}
        finally:
            jax.random.bernoulli = bernoulli
        new = jax.tree_util.tree_map(np.asarray, (new.params, new.batch_stats,
                                                  new.opt_state[1][0].mu))
    finally:
        j_steps.normalize_images = normalize
        jax.config.update('jax_enable_x64', x64)
    new_params, new_stats, new_mu = new
    assert sorted(draws) == list(range(1 + s)), sorted(draws)
    np.testing.assert_array_equal(draws[0], flips)
    keep = [torch.from_numpy(draws[1 + i].copy()).permute(0, 3, 1, 2) for i in range(s)]

    def carry(params, stats):
        return {k: t.numpy() for k, t in state_dict_from_flax(params, stats, tc).items()}

    model = BEVDepthLiDAR(tc, device='cpu').to(torch.float64 if fp64 else torch.float32)
    model.load_state_dict(state_dict_from_flax(v['params'], v['batch_stats'], tc))
    state = create_train_state(tc, model, steps_per_epoch=10)
    p_eval = None
    if with_eval and not fp64:
        p_eval = make_eval_step(tc)(state, dict(batch, sample_valid=np.array([True, False])))
        p_eval = jax.tree_util.tree_map(lambda t: t.numpy(), p_eval)
    old = {n: p.detach().clone().numpy() for n, p in model.named_parameters()}
    state, p_met = make_train_step(tc)(state, batch, {'flipped': torch.from_numpy(flips.copy()),
                                                      'dropout': keep})
    names = [n for n, _ in model.named_parameters()]
    return {
        'lr': tc.learning_rate,
        'flips': flips,
        'camera': True,
        'j_metrics': j_met,
        'p_metrics': {k: float(x) for k, x in p_met.items()},
        'j_mu': carry(new_mu, v['batch_stats']),
        'p_mu': {n: m.numpy() for n, m in zip(names, state.optimizer.mu)},
        'j_old': carry(v['params'], v['batch_stats']),
        'j_new': carry(new_params, v['batch_stats']),
        'p_old': old,
        'p_new': {n: p.detach().numpy() for n, p in model.named_parameters()},
        'j_stats': carry(v['params'], new_stats),
        'p_stats': {n: b.numpy() for n, b in model.named_buffers()},
        'j_eval': j_eval,
        'p_eval': p_eval,
    }


def check_train_metrics(case, case64) -> None:
    """Loss to 1e-5 relative in float32 (sums in another order) and 1e-6 in
    float64, and with the camera its detection and depth parts alike (the
    depth loss is a float32 computation in both packages, also in the
    float64 run); the gradient norm to 1e-6 in float64 and 1e-2 in float32
    (the cancellation described in :func:`train_parity_case`)."""
    for c, tol_loss, tol_norm in ((case, 1e-5, 1e-2), (case64, 1e-6, 1e-6)):
        j, p = c['j_metrics'], c['p_metrics']
        assert j['train_loss'] > 1.0
        assert abs(p['train_loss'] - j['train_loss']) <= tol_loss * j['train_loss']
        if c.get('camera'):
            assert j['train_depth_loss'] > 1.0
            for k in ('train_detection_loss', 'train_depth_loss'):
                assert abs(p[k] - j[k]) <= tol_loss * j[k], k
        else:
            assert p['train_depth_loss'] == j['train_depth_loss'] == 0
            assert p['train_detection_loss'] == p['train_loss']
        assert abs(p['grad_norm'] - j['grad_norm']) <= tol_norm * j['grad_norm']


def check_train_gradients(case64) -> None:
    """Every clipped gradient (Adam's first moment / 0.1; float64) within
    1e-4 of its tensor's largest |g|; the zero-gradient biases within 1e-5
    of the model's largest."""
    j_mu, p_mu = case64['j_mu'], case64['p_mu']
    top = max(np.abs(m).max() for n, m in j_mu.items() if n in p_mu)
    assert set(p_mu) <= set(j_mu)
    for name, g in p_mu.items():
        if name in ZERO_GRAD_BIASES + CAMERA_ZERO_GRAD_BIASES:
            assert np.abs(g).max() <= 1e-5 * top, name
            continue
        want = j_mu[name]
        assert np.abs(g - want).max() <= 1e-4 * np.abs(want).max(), name


def check_train_update(case, case64) -> None:
    """Adam's first step is about lr * sign(g): the update (new - old)
    within 2.001 lr everywhere (a sign of g at rounding level may flip; the
    weight decay adds lr * 1e-7 * |p|) and,
    in float64, within 1e-3 lr where |g| exceeds 1e-4 of its tensor's
    largest."""
    for c in (case, case64):
        lr = c['lr']
        for name, p_new in c['p_new'].items():
            got = p_new - c['p_old'][name]
            want = c['j_new'][name] - c['j_old'][name]
            assert np.abs(got - want).max() <= 2.001 * lr, name
            if c is case64:
                g = np.abs(c['j_mu'][name])
                strong = g > 1e-4 * g.max()
                assert np.abs(got - want)[strong].max(initial=0) <= 1e-3 * lr, name
        moved = sum(np.abs(p - c['p_old'][n]).sum() for n, p in c['p_new'].items())
        assert moved > 0


def check_train_bn_stats(case, case64) -> None:
    """New running means and variances to 1e-5, in float32 and float64."""
    for c in (case, case64):
        n = 0
        for name, got in c['p_stats'].items():
            if name.endswith(('running_mean', 'running_var')):
                np.testing.assert_allclose(got, c['j_stats'][name], rtol=1e-5, atol=1e-5,
                                           err_msg=name)
                n += 1
        assert n > 20


def check_eval_step(case) -> None:
    """Eval loss on the padded batch to 1e-5 relative (with the camera the
    depth loss too, and the first camera's depth viz to 1e-5); boxes as the
    predict parity holds them (valid and labels equal, scores 1e-4, boxes
    1e-3)."""
    (jm, (wb, ws, wl, wv)), (pm, (gb, gs, gl, gv)) = case['j_eval'][:2], case['p_eval'][:2]
    keys = ('detection_loss', 'depth_loss', 'loss') if case.get('camera') else (
        'detection_loss', 'loss')
    for k in keys:
        assert abs(float(pm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    if case.get('camera'):
        assert float(jm['depth_loss']) > 1.0
        jd, pd = case['j_eval'][2]['depth'], case['p_eval'][2]['depth']
        assert pd.shape == jd.shape and pd.dtype == np.float32
        np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-5)
    else:
        assert float(pm['depth_loss']) == 0.0
    np.testing.assert_array_equal(gv, wv)
    assert wv.sum() > 50
    np.testing.assert_array_equal(gl[wv], wl[wv])
    np.testing.assert_allclose(gs, ws, atol=1e-4)
    for b, i in zip(*np.nonzero(wv)):
        same = gv[b] & (gl[b] == wl[b, i]) & (np.abs(gs[b] - ws[b, i]) <= 1e-4)
        assert np.abs(gb[b, same] - wb[b, i]).max(-1).min() <= 1e-3, (b, i)
