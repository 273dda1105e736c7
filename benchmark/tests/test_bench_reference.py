"""The plain reference against the port's CPU path at the tiny geometry,
and the benchmark's imports."""
import ast
from pathlib import Path

import pytest

from bench_tiny import run_tiny

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize('use_cam', [False, True])
def test_reference_follows_the_port_train_step(use_cam):
    out = run_tiny('train', use_cam, 'lcr_train_b4')
    n = out['numbers']
    # float32 on both sides: the same arithmetic up to the order of sums
    assert n['loss_gap'] < 1e-4 and n['grad_gap'] < 1e-4 and n['bn_gap'] < 1e-4, n
    assert n['change_gap'] < 2e-2, n
    assert out['correct']


@pytest.mark.parametrize('use_cam', [False, True])
def test_reference_follows_the_port_predict_step(use_cam):
    out = run_tiny('predict', use_cam, 'lcr_predict_b4')
    assert all(v < 1e-4 for v in out['numbers'].values()), out['numbers']
    assert out['correct']


def _imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split('.')[0])
    return names


def test_nothing_on_the_chip_imports_jax_or_the_jax_package():
    """Top-level names compared whole: the port's name begins with the JAX
    package's."""
    for path in BENCH.rglob('*.py'):
        found = _imports(path) & {'jax', 'jaxlib', 'flax', 'mm_training_tpu'}
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / 'reference').rglob('*.py'):
        assert 'mm_training_tpu_torch' not in _imports(path), path
        assert 'benchmark' not in _imports(path), path
