"""``python3 benchmark/run.py --workload W --seed N --seconds S --trace 0|1``.

Finds the cell in ``BENCHMARK.json``, its configuration file, its traffic
file (``benchmark/traffic/<traffic>.json``), its limits
(``benchmark/limits/<workload>.json``) and a reader for each metric it
reports (``benchmark/metrics/<metric>.py``), runs it on the card and prints
one JSON line. ``--side control`` puts the reference's float8 products in
the program's place and ``--fault`` breaks the program underneath: both
are for setting and proving the limits; the scored runs use neither.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from .programs import FAULTS

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / 'benchmark'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mm_training_tpu')


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, bench: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The cell's entry and every file it is made of, found by name."""
    bench = bench or load_json(ROOT / 'BENCHMARK.json')
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'no workload {workload!r} in BENCHMARK.json')
    cell = cells[workload]
    config = {c['name']: c for c in bench['configs']}[cell['config']]

    def mine(metric):
        return 'workloads' not in metric or workload in metric['workloads']
    return {'workload': workload, 'cell': cell,
            'config': load_json(ROOT / config['file']),
            'traffic': load_json(BENCH / 'traffic' / f'{cell["traffic"]}.json'),
            'limits': load_json(BENCH / 'limits' / f'{workload}.json'),
            'end_to_end': [m for m in bench['end_to_end'] if mine(m)],
            'per_layer': [m for m in bench['per_layer'] if mine(m)]}


def reader(name: str):
    """The ``read(out)`` function of ``benchmark/metrics/<name>.py``."""
    path = BENCH / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(f'benchmark_metric_{name}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (whole names: ``mm_training_tpu_torch`` is not one)."""
    return sorted({m.split('.')[0] for m in list(sys.modules)} & set(FORBIDDEN))


def metrics_of(defs, out) -> Dict[str, Dict[str, Any]]:
    """Each metric its reader finds something to read for. A share of a
    roofline or of the peak over 100% is a counting error (the operations
    or bytes counted too high, or the time leaving out part of the work):
    it raises rather than print."""
    metrics = {}
    for m in defs:
        value = reader(m['name'])(out)
        if value is None:
            continue
        if ('roofline' in m['name'] or 'mfu' in m['name']) and not 0 < value <= 100:
            raise ValueError(f'{m["name"]} = {value}: a share of a roofline or of the peak '
                             'is above 0 and at most 100; the count is wrong')
        metrics[m['name']] = {'value': value, 'unit': m['unit']}
    return metrics


def result_line(spec, out, trace_on: bool, device_kind: str, chips: int) -> Dict[str, Any]:
    """The last line: the contract's keys, the compared numbers last."""
    from . import trace
    device = {'platform': 'gpu', 'kind': device_kind, 'count': chips,
              'memory_peak_bytes': out['memory_peak_bytes']}
    line: Dict[str, Any] = {'correct': out['correct'], 'attempted': out['attempted'],
                            'failed': out['failed']}
    if trace_on:
        sl = out['slice']
        line['metrics'] = metrics_of(spec['per_layer'], out)
        device['busy_s'] = trace.busy_seconds(sl['device'])
        device['window_s'] = sl['window_s']
        line['device'] = device
        line['breakdown'] = {'device_ops': trace.top_device_ops(sl['device']),
                             'idle_gaps': trace.idle_gaps(sl['device'], sl['host'])}
    else:
        line['metrics'] = metrics_of(spec['end_to_end'], out)
        line['device'] = device
    line['checks'] = {k: {'value': v, 'limit': spec['limits'].get(k)}
                      for k, v in out['numbers'].items()}
    return line


def power_limit() -> str:
    try:
        return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                               '--format=csv,noheader'], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'nvidia-smi: {e}'


def main(argv=None, t_start: float = 0.0) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--side', choices=('program', 'control'), default='program')
    ap.add_argument('--fault', choices=FAULTS)
    args = ap.parse_args(argv)

    import torch
    spec = cell_spec(args.workload)
    chips = spec['cell']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'{args.workload} needs {chips} CUDA device(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} available',
              file=sys.stderr)
        return 2
    from mm_training_tpu_torch.ops import build
    build.build_kernels()
    from .cell import Run
    out = Run(spec, args.seed, args.seconds, bool(args.trace), 'cuda', t_start,
              side=args.side, fault=args.fault,
              log=lambda s: print(s, file=sys.stderr)).run()
    found = forbidden_modules()
    if found:
        print(f'modules of JAX or of the JAX package were loaded: {found}', file=sys.stderr)
        return 3
    line = result_line(spec, out, bool(args.trace), torch.cuda.get_device_name(0), chips)
    print(f'card: {power_limit()}', file=sys.stderr)
    for k, c in line['checks'].items():
        print(f'check {k} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    print(json.dumps(line, allow_nan=True))
    return 0
