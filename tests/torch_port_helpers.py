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


def check_predict_parity(use_radar: bool) -> None:
    """The port's predict step against the JAX package's ``make_predict_step``
    on ``tiny_test_config(use_cam=False)`` at narrow widths, fp32.

    Random flax variables are carried over by ``state_dict_from_flax``; the
    request batch comes from both packages' ``make_fake_batch``. Valid flags
    and labels must be equal, scores within 1e-4 and each kept box within
    1e-3 (m, rad, m/s) (tests/test_models/test_full_pipeline_parity.py's
    tolerances). Two kept boxes whose scores tie to rounding may trade
    slots, so a box is looked up among the kept boxes of its row with the
    same label and score."""
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
    got = [a.numpy() for a in make_predict_step(tc, model)(batch)]

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
