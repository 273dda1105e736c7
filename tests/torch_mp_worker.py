"""The cases of ``tests/test_torch_spatial.py`` and
``tests/test_torch_model_parallel.py``, run by each rank of a gloo world of
CPU processes (``parallel/dryrun.py::spawn_ranks``, which lays the world out
by ``make_mesh`` and bars jax, flax and the JAX package from the ranks'
interpreters) and, in the test process, by one process without a group on
the whole input. Each case returns this rank's share (its W shard, its rows)
or, without a group, the whole, as numpy arrays.
"""
import dataclasses

import numpy as np
import torch

# (name, kind, kernel, stride, padding): the head's ops that read beyond
# their own columns
HALO_OPS = (('conv3x3s1', 'conv', 3, 1, 1), ('conv3x3s2', 'conv', 3, 2, 1),
            ('conv7x7s2', 'conv', 7, 2, 3), ('maxpool3x3s2', 'pool', 3, 2, 1))
HALO_SHAPE = (2, 3, 5, 16)          # [B, C, H, W]: W splits over 4 ranks, 2 a stride
STEP_B = 2                          # the step cases' global batch
EVAL_VALID = (True, False)          # the eval case's second sample is padding


def _np(t):
    return t.detach().cpu().numpy().copy()


def _axis():
    from mm_training_tpu_torch import parallel
    return parallel.model_axis()


def _cols(width):
    """This rank's columns of a map ``width`` wide (all without an axis)."""
    from mm_training_tpu_torch.parallel import spatial
    axis = _axis()
    return (0, width) if axis is None else spatial.columns(width, axis)


def halo_cases(seed: int = 0) -> dict:
    """Each op of :data:`HALO_OPS` in float64 on this rank's W shard of a
    random [2, 3, 5, 16] input through ``parallel/spatial.py``: its output
    shard and the input shard's gradient of a random weighting of the whole
    output."""
    from mm_training_tpu_torch.parallel import spatial
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(HALO_SHAPE)
    out = {}
    for name, kind, k, s, p in HALO_OPS:
        conv = torch.nn.Conv2d(3, 4, k, s, p).double()
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(rng.standard_normal(conv.weight.shape)))
            conv.bias.copy_(torch.from_numpy(rng.standard_normal(4)))
        w_out = HALO_SHAPE[-1] // s
        cot = rng.standard_normal((2, 4 if kind == 'conv' else 3, 5 // s + (5 % s > 0), w_out))
        lo, hi = _cols(HALO_SHAPE[-1])
        xs = torch.from_numpy(x[..., lo:hi].copy()).requires_grad_()
        if kind == 'conv':
            y = spatial.conv2d(conv, xs, _axis())
        else:
            y = spatial.max_pool2d(xs, k, s, p, _axis())
        olo, ohi = _cols(w_out)
        (y * torch.from_numpy(cot[..., olo:ohi].copy())).sum().backward()
        out[name] = {'y': _np(y), 'dx': _np(xs.grad)}
    return out


def head_case(hconf, state, x, cot, train: bool) -> dict:
    """The head ``BEVDepthHead(hconf)`` with ``state`` (float64), in train
    or eval mode, on this rank's W shard of ``x`` (NHWC numpy): its maps'
    shards, the input shard's gradient of the maps weighted by ``cot``
    (NHWC numpy maps, whole) and this rank's share of the parameter
    gradients."""
    from mm_training_tpu_torch.models import BEVDepthHead
    from mm_training_tpu_torch.parallel import spatial
    head = BEVDepthHead(hconf)
    head.load_state_dict(state)
    head.to(torch.float64, memory_format=torch.channels_last).train(train)
    full = torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)
    xin = full.contiguous(memory_format=torch.channels_last).requires_grad_()
    preds = head(spatial.shard_w(xin, _axis()), _axis())
    lo, hi = _cols(cot[0]['heatmap'].shape[2])
    total = sum((p[k] * torch.from_numpy(c[k][:, :, lo:hi].copy())).sum()
                for p, c in zip(preds, cot) for k in p)
    total.backward()
    # shard_w's backward hands every model peer the whole input gradient
    return {'maps': [{k: _np(v) for k, v in p.items()} for p in preds],
            'dx': _np(xin.grad.permute(0, 2, 3, 1)),
            'dparams': {n: _np(p.grad) for n, p in head.named_parameters()
                        if p.grad is not None},
            'stats': {n: _np(b) for n, b in head.named_buffers() if 'running' in n}}


def spatial_cases(head_spec) -> dict:
    """:func:`halo_cases`, and :func:`head_case` in train and eval mode
    when ``head_spec`` (hconf, state, x, cot) is given."""
    out = {'halo': halo_cases()}
    if head_spec is not None:
        out['head_train'] = head_case(*head_spec, train=True)
        out['head_eval'] = head_case(*head_spec, train=False)
    return out


def narrow_overrides(camera: bool = False) -> dict:
    """The config fields of ``tests/torch_ddp_worker.py::narrow`` (and
    ``narrow_cam``): ``run_one_train_step``'s overrides."""
    from mm_training_tpu_torch.configs import tiny_test_config
    from tests.torch_ddp_worker import narrow, narrow_cam
    cfg = (narrow_cam if camera else narrow)(tiny_test_config(use_cam=camera))
    keys = ('lidar_conf', 'head_conf') + (('backbone_conf',) if camera else ())
    return {k: getattr(cfg, k) for k in keys}


def step_spec(camera: bool = False) -> dict:
    """``parallel/dryrun.py::train_step_rank``'s spec of the narrow tiny L+R
    step in float64 at a global batch of :data:`STEP_B` (the camera's draws
    from the step's own generator)."""
    from mm_training_tpu_torch.configs import tiny_test_config
    from mm_training_tpu_torch.data import make_fake_batch
    overrides = narrow_overrides(camera)
    cfg = tiny_test_config(use_cam=camera, batch_size=STEP_B).replace(**overrides)
    return {'factory': 'mm_training_tpu_torch.configs:tiny_test_config',
            'modalities': dict(use_cam=camera, use_lidar=True, use_radar=True),
            'batch': make_fake_batch(cfg, seed=3), 'state': None, 'draws': None,
            'dtype': torch.float64, 'overrides': overrides, 'device': 'cpu', 'seed': 4}


def _eval_setup(spec):
    """(a data rank's config, a float64 train state from the spec's seed)."""
    from mm_training_tpu_torch import parallel
    from mm_training_tpu_torch.configs import tiny_test_config
    from mm_training_tpu_torch.models import BEVDepthLiDAR
    from mm_training_tpu_torch.training import create_train_state
    cfg = tiny_test_config(batch_size=STEP_B // parallel.data_parallel_size(),
                           model_parallel=parallel.current_mesh().model_parallel,
                           **spec['modalities']).replace(**spec['overrides'])
    model = BEVDepthLiDAR(cfg, device='cpu', generator=torch.Generator().manual_seed(
        spec['seed'])).to(torch.float64)
    return cfg, create_train_state(cfg, model, steps_per_epoch=10)


def _boxes(out):
    return dict(zip(('boxes', 'scores', 'labels', 'valid'), (_np(t) for t in out)))


def step_cases(spec) -> dict:
    """One train step (``train_step_rank``), then from fresh weights the
    eval step on a batch whose second sample is padding, and the predict
    steps with the flip ensemble and on the folded weights: this rank's
    rows of each."""
    from mm_training_tpu_torch import parallel
    from mm_training_tpu_torch.models.bn_fold import fold_state
    from mm_training_tpu_torch.parallel.dryrun import train_step_rank
    from mm_training_tpu_torch.training import make_eval_step, make_state_predict_step
    out = {'train': train_step_rank(spec)}
    cfg, state = _eval_setup(spec)
    batch = dict(spec['batch'], sample_valid=np.asarray(EVAL_VALID))
    rows = parallel.shard_batch(batch, 'cpu')
    metrics, boxes, viz = make_eval_step(cfg)(state, rows)
    out['eval'] = dict(_boxes(boxes), metrics={k: float(v) for k, v in metrics.items()},
                       heatmaps=_np(viz['heatmaps']))
    out['tta'] = _boxes(make_state_predict_step(dataclasses.replace(cfg, use_tta=True))(
        state, rows))
    out['folded'] = _boxes(make_state_predict_step(cfg)(fold_state(state), rows))
    return out


def cuda_shard_case() -> dict:
    """On the card (float32, TF32 off): a 3x3 ConvBN in train mode (kernel
    A on the statistics of the whole map, its backward A') on this rank's W
    shard of a [4, 64, 16, 64] input through the halo pad: its output
    shard, the input gradient of a random weighting of the whole output,
    the parameter gradients (this rank's share) and the launches of A and
    A'."""
    from mm_training_tpu_torch.models.resnet import ConvBN
    from mm_training_tpu_torch.ops import affine_act
    from mm_training_tpu_torch.parallel import spatial
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((4, 64, 16, 64), np.float32))
    cot = torch.from_numpy(rng.standard_normal((4, 64, 16, 64), np.float32))
    torch.manual_seed(0)
    block = ConvBN(64, 64, 3).cuda().to(memory_format=torch.channels_last).train()
    lo, hi = _cols(64)
    xs = x[..., lo:hi].cuda().contiguous(memory_format=torch.channels_last).requires_grad_()
    affine_act.affine_act.launches = affine_act.affine_act_backward.launches = 0
    y = block(xs, _axis())
    (y * cot[..., lo:hi].cuda()).sum().backward()
    torch.cuda.synchronize()
    return {'y': _np(y), 'dx': _np(xs.grad),
            'dparams': {n: _np(p.grad) for n, p in block.named_parameters()},
            'launches': (affine_act.affine_act.launches,
                         affine_act.affine_act_backward.launches)}
