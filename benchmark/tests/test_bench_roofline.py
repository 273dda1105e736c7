"""The step's FLOP count against ``FlopCounterMode`` over the reference, and
the harness's refusal of a share above 100%."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_tiny import tiny_spec
from benchmark.harness import frozen, programs, traffic as traffic_mod
from benchmark.harness.main import metrics_of
from benchmark.roofline import flops as flops_mod
from benchmark.roofline.kernels import KERNEL_NAMES

SEED = 2 ** 31 + 11


@pytest.mark.parametrize('loop', ['train', 'predict'])
def test_step_flops_match_the_flop_counter(loop):
    spec = tiny_spec(loop, True, 'lcr_train_b4')
    side = (programs.ReferenceTrain if loop == 'train' else programs.ReferencePredict)(
        spec['config']['config'], SEED, 'cpu')
    cfg = side.cfg
    batch = traffic_mod.make_pool(cfg, spec['traffic'], SEED)[0]
    log = flops_mod.LayerLog(side.model)
    log.active = True
    with FlopCounterMode(display=False) as counter:
        if loop == 'train':
            gen = torch.Generator().manual_seed(SEED)
            side.step(batch, frozen.draw_train_randoms(cfg, batch['imgs'].shape, gen, 'cpu'))
        else:
            side(batch)
    ours = flops_mod.step_flops(log, cfg, 2, loop == 'train')
    theirs = counter.get_total_flops()
    # the counter also counts the few small matrix products of the geometry
    assert ours == pytest.approx(theirs, rel=0.02), (ours, theirs)


def _out(bound_s, spent_s):
    name = 'void ' + KERNEL_NAMES['A'] + '<bf16>'
    return {'loop': 'train', 'kernel_bounds_s': {'A': bound_s}, 'step_flops': 1e12,
            'stats': {'mean_s': 0.1},
            'slice': {'steps': 1, 'device': [(name, 0.0, spent_s)], 'host': [],
                      'window_s': 0.2}}


def test_a_roofline_share_within_100_is_reported():
    m = metrics_of([{'name': 'kernel_roofline_pct.train', 'unit': '%'}], _out(1e-3, 2e-3))
    assert m['kernel_roofline_pct.train']['value'] == pytest.approx(50.0)


def test_a_roofline_share_above_100_raises():
    """A kernel cannot beat its least time: more than 100% means its bytes
    or operations were counted too high, or its time left out work."""
    with pytest.raises(ValueError, match='count is wrong'):
        metrics_of([{'name': 'kernel_roofline_pct.train', 'unit': '%'}], _out(3e-3, 2e-3))
    with pytest.raises(ValueError, match='count is wrong'):
        metrics_of([{'name': 'mfu_pct.train', 'unit': '%'}], dict(_out(1e-3, 2e-3), step_flops=1e15))
