"""The harness's own arithmetic and layout: the last line, the window's
rate and tail, the idle share, and the discovery of every piece by name."""
import json
import time

import pytest

import bench_tiny  # noqa: F401  (the repository root on the path)
from benchmark.harness import trace
from benchmark.harness.cell import closed_loop, window_stats
from benchmark.harness.main import BENCH, ROOT, cell_spec, load_json, main, reader, result_line

CONTRACT_KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


def _out(loop='train'):
    name = 'void affine_act_kernel<bf16>'
    return {'loop': loop, 'correct': True, 'attempted': 40, 'failed': 0,
            'memory_peak_bytes': 123, 'setup_s': 42.0, 'step_flops': 1e12,
            'stats': {'rate': 12.0, 'p90_ms': 330.0, 'p95_ms': 340.0, 'mean_s': 0.3},
            'kernel_bounds_s': {'A': 0.001},
            'slice': {'steps': 2, 'window_s': 0.7, 'host': [('aten::copy_', 0.0, 0.5)],
                      'device': [(name, 0.0, 0.1), ('gemm', 0.05, 0.2), (name, 0.4, 0.45)]},
            'numbers': {'loss_gap': 0.001, 'grad_gap': 0.01}}


@pytest.mark.parametrize('trace_on', [False, True])
def test_the_last_line_holds_the_contract_keys_and_the_checks_last(trace_on):
    spec = cell_spec('lcr_train_b4')
    line = result_line(spec, _out(), trace_on, 'NVIDIA H100 80GB HBM3', 1)
    keys = list(line)
    assert keys[-1] == 'checks'
    assert keys[:-1] == CONTRACT_KEYS + (['breakdown'] if trace_on else [])
    assert set(line['device']) == ({'platform', 'kind', 'count', 'memory_peak_bytes'}
                                   | ({'busy_s', 'window_s'} if trace_on else set()))
    wanted = spec['per_layer'] if trace_on else spec['end_to_end']
    assert set(line['metrics']) == {m['name'] for m in wanted}
    assert json.loads(json.dumps(line)) == line
    if trace_on:
        assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}
        assert all(len(v) <= 10 for v in line['breakdown'].values())


def test_a_stall_moves_the_rate_and_the_tail():
    """Rate and tail are taken over every step of the whole window."""
    def steady():
        time.sleep(0.004)
    calls = [0]

    def stalling():
        calls[0] += 1
        time.sleep(0.05 if calls[0] % 5 == 0 else 0.004)

    base = window_stats(*closed_loop(steady, 0.3), 4)
    stalled = window_stats(*closed_loop(stalling, 0.3), 4)
    assert stalled['rate'] < 0.6 * base['rate']
    assert stalled['p90_ms'] > 5 * base['p90_ms']


def test_the_window_counts_its_last_step():
    durations, window = closed_loop(lambda: time.sleep(0.02), 0.05)
    assert window >= 0.05 and len(durations) >= 2
    assert window_stats(durations, window, 4)['rate'] == pytest.approx(4 * len(durations) / window)


def test_busy_time_is_the_union_and_idle_is_against_the_unprofiled_step():
    out = _out()
    assert trace.busy_seconds(out['slice']['device']) == pytest.approx(0.25)
    assert reader('device_busy_ms.train')(out) == pytest.approx(125.0)
    # 125 ms busy a step against the unprofiled 300 ms, not the profiled 350
    assert reader('device_idle_pct.train')(out) == pytest.approx(100 * (1 - 0.125 / 0.3))
    assert reader('device_ops_per_step.train')(out) == pytest.approx(1.5)
    assert reader('device_idle_pct.predict')(out) is None
    gaps = trace.idle_gaps(out['slice']['device'], out['slice']['host'])
    assert gaps == [['aten::copy_', pytest.approx(0.2)]]


def test_every_piece_is_found_by_its_name():
    bench = load_json(ROOT / 'BENCHMARK.json')
    for m in bench['end_to_end'] + bench['per_layer']:
        assert (BENCH / 'metrics' / f'{m["name"]}.py').is_file(), m['name']
    for c in bench['configs']:
        assert load_json(ROOT / c['file'])['name'] == c['name']
    for w in bench['workloads']:
        spec = cell_spec(w['name'], bench)
        assert spec['traffic']['loop'] in ('train', 'predict')
        assert set(spec['limits']) and all(v >= 0 for v in spec['limits'].values())
        assert any(m['name'] == 'setup_s' for m in spec['end_to_end'])
        assert len(spec['end_to_end']) >= 2 and spec['per_layer']


def test_a_new_metric_is_found_by_its_file(tmp_path, monkeypatch):
    import benchmark.harness.main as m
    (tmp_path / 'metrics').mkdir()
    (tmp_path / 'metrics' / 'made_up.train.py').write_text('def read(out):\n    return 7.0\n')
    monkeypatch.setattr(m, 'BENCH', tmp_path)
    assert m.reader('made_up.train')({}) == 7.0


def test_without_a_card_the_run_prints_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    assert main(['--workload', 'lcr_train_b4', '--seed', '1', '--seconds', '1']) != 0
    assert capsys.readouterr().out == ''


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """A short run of the camera train cell, started as a scored run is."""
    import subprocess
    import sys
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload', 'lcr_train_b4',
                          '--seed', str(2 ** 32 + 3), '--seconds', '3', '--trace', '0'],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line['correct'] and line['device']['platform'] == 'gpu'
