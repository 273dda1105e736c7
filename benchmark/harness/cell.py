"""One run of one cell: set-up, the measured window, the optional profiled
slice, the comparison with the reference, and the result.

Set-up builds the program's state from the seed, makes the cell's pool of
host batches and drives the first steps (or warm-up calls), which the
comparison checks. The window then runs the same object in a closed loop
with one client for ``seconds``: the next batch is handed over once the
previous result is on the host (a train step's loss read, a predict call's
boxes, scores, labels and valid copied back). Every step or call of the
window counts in the rate and in the tail. After the window (and the
slice), the peak memory is read, the program freed, and the reference
follows the checked steps or calls.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import frozen, judge, programs, trace, traffic as traffic_mod
from ..roofline import flops as flops_mod, kernels as kernels_mod


def quantile(values: List[float], q: float) -> float:
    """The q-quantile of every value (linear between order statistics)."""
    return float(np.quantile(np.asarray(values, np.float64), q))


def window_stats(durations: List[float], window_s: float, per_step: int) -> Dict[str, float]:
    """Rate over all the work and all the time of the window, and tails
    over every step in it."""
    return {'rate': per_step * len(durations) / window_s,
            'p90_ms': quantile(durations, 0.90) * 1e3,
            'p95_ms': quantile(durations, 0.95) * 1e3,
            'mean_s': window_s / len(durations)}


def closed_loop(one: Callable[[], None], seconds: float):
    """Call ``one`` back to back for ``seconds`` (at least once): (each
    call's host-clock duration, the window's whole length)."""
    durations = []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        one()
        te = time.perf_counter()
        durations.append(te - ts)
        if te - t0 >= seconds:
            return durations, te - t0


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


class Run:
    """The cell's run. ``spec``: {'workload', 'config' (the configuration
    file's object), 'traffic', 'limits'}; ``side``: 'program' (the port,
    optionally broken by ``fault``) or 'control' (the reference's float8
    products in the program's place)."""

    def __init__(self, spec: Dict[str, Any], seed: int, seconds: float, trace_on: bool,
                 device, t_start: float, side: str = 'program', fault: Optional[str] = None,
                 log: Callable[[str], None] = print):
        self.spec, self.seed, self.seconds = spec, seed, seconds
        self.trace_on, self.device, self.t_start = trace_on, torch.device(device), t_start
        self.side, self.fault, self.log = side, fault, log
        self.traffic = spec['traffic']
        self.cfg_dict = spec['config']['config']
        self.out: Dict[str, Any] = {}

    # ------------------------------------------------------------------ train
    def _draws(self, cfg, pool, gen):
        if not cfg.use_cam:
            return None
        return frozen.draw_train_randoms(cfg, pool[0]['imgs'].shape, gen, self.device)

    def _train_readings(self, side, pool, gen, initial, layers=None):
        """The checked steps' readings; ``layers`` (the reference's
        :class:`~benchmark.roofline.flops.LayerLog`) logs the first step's
        forward."""
        losses = []
        for i in range(self.traffic['checked_steps']):
            if layers is not None:
                layers.active = i == 0
            parts = side.step(pool[i % len(pool)], self._draws(side.cfg, pool, gen))
            losses.append([float(x) for x in parts])
            if i == 0:
                grad_norms = side.grad_norms()
        return {'losses': losses, 'grad_norms': grad_norms,
                'change_norms': side.change_norms(initial()), 'bn_norms': side.bn_norms()}

    def _initial(self, model, cfg):
        from . import weights
        return lambda: weights.make(model, self.seed, cfg.get_head_conf().init_bias, self.device)

    def train(self):
        seed, dev = self.seed, self.device
        if self.side == 'control':
            prog = programs.ReferenceTrain(self.cfg_dict, seed, dev, fp8=True)
        else:
            prog = programs.PortTrain(self.cfg_dict, seed, dev, self.fault)
        cfg = prog.cfg
        pool = traffic_mod.make_pool(cfg, self.traffic, seed)
        gen = torch.Generator(device=dev).manual_seed(seed % 2 ** 63)
        readings = self._train_readings(prog, pool, gen, self._initial(prog.model, cfg))
        _sync(dev)
        self.out['setup_s'] = time.perf_counter() - self.t_start

        b = self.traffic['batch_size']
        i = self.traffic['checked_steps']
        failed = 0

        def one():
            nonlocal i, failed
            loss = prog.step(pool[i % len(pool)], self._draws(cfg, pool, gen))[0]
            if not math.isfinite(loss.item()):
                failed += 1
            i += 1

        durations = self._window(one)
        self.out['attempted'], self.out['failed'] = len(durations) * b, failed * b
        self.out['stats'] = window_stats(durations, self.out['window_s'], b)
        if self.trace_on:
            self._slice(one, self.traffic['profiled_steps'])
        self._close()
        del prog
        self._free()

        ref = programs.ReferenceTrain(self.cfg_dict, seed, dev)
        layers = flops_mod.LayerLog(ref.model)
        gen = torch.Generator(device=dev).manual_seed(seed % 2 ** 63)
        expected = self._train_readings(ref, pool, gen, self._initial(ref.model, ref.cfg), layers)
        layers.remove()
        self._roofline(ref.cfg, layers, train=True)
        self.numbers = judge.train_numbers(readings, expected)
        g = np.asarray(expected['grad_norms'])
        for what, names, keep in (('grad', ref.leaf_names(), None),
                                  ('change', ref.leaf_names(), g >= 1e-3 * np.median(g)),
                                  ('bn', ref.bn_names(), None)):
            worst = judge.worst_leaves(readings[f'{what}_norms'], expected[f'{what}_norms'],
                                       names, keep=keep)
            self.log(f'worst {what} leaves (program, reference): {worst}')
        self.log(f'losses program {readings["losses"]} reference {expected["losses"]}')

    # ---------------------------------------------------------------- predict
    def predict(self):
        seed, dev = self.seed, self.device
        if self.side == 'control':
            control = programs.ReferencePredict(self.cfg_dict, seed, dev, fp8=True)
            cfg = control.cfg

            def prog(batch):
                return control(batch)[0]
        else:
            prog = programs.PortPredict(self.cfg_dict, seed, dev, self.fault)
            cfg = prog.cfg
        pool = traffic_mod.make_pool(cfg, self.traffic, seed)
        for i in range(self.traffic['warmup_calls']):
            prog(pool[i % len(pool)])
        _sync(dev)
        self.out['setup_s'] = time.perf_counter() - self.t_start

        n = len(pool)
        # the checked call of each pool batch: its r-th use in the window,
        # r drawn from the seed (or its last use, in a short window)
        pick = np.random.default_rng([self.seed, 2]).integers(0, 4, n)
        uses, kept = [0] * n, [None] * n
        calls, failed = 0, 0

        def one():
            nonlocal calls, failed
            j = calls % n
            out = prog(pool[j])
            if uses[j] <= pick[j]:
                kept[j] = out
            uses[j] += 1
            calls += 1
            if not all(torch.isfinite(t.float()).all() for t in out[:2]):
                failed += 1

        durations = self._window(one)
        b = self.traffic['batch_size']
        self.out['attempted'], self.out['failed'] = len(durations) * b, failed * b
        self.out['stats'] = window_stats(durations, self.out['window_s'], b)
        if self.trace_on:
            self._slice(one, self.traffic['profiled_steps'])
        self._close()
        del prog
        if self.side == 'control':
            del control
        self._free()

        ref = programs.ReferencePredict(self.cfg_dict, seed, dev)
        layers = flops_mod.LayerLog(ref.model)
        checked = [j for j in range(n) if kept[j] is not None][:self.traffic['checked_calls']]
        refs = []
        for j in checked:
            layers.active = j == checked[0]
            refs.append(ref(pool[j]))
        layers.remove()
        self._roofline(ref.cfg, layers, train=False)
        self.numbers = judge.predict_numbers(ref.cfg.get_head_conf(),
                                             [kept[j] for j in checked], refs,
                                             self.spec['limits'], self.log)
        own = judge.predict_numbers(ref.cfg.get_head_conf(), [r[0] for r in refs], refs,
                                    self.spec['limits'])
        self.log(f'the reference\'s own decode against the kept set\'s rule: {own}')

    # ------------------------------------------------------------------ parts
    def _window(self, one: Callable[[], None]) -> List[float]:
        durations, self.out['window_s'] = closed_loop(one, self.seconds)
        return durations

    def _slice(self, one: Callable[[], None], steps: int) -> None:
        def run():
            for _ in range(steps):
                one()
        self.out['slice'] = dict(trace.profile_slice(run), steps=steps)

    def _close(self) -> None:
        """Read what the window leaves before the program is freed."""
        if self.device.type == 'cuda':
            torch.cuda.synchronize()
            self.out['memory_peak_bytes'] = torch.cuda.max_memory_allocated(self.device)

    def _free(self) -> None:
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    def _roofline(self, cfg, layers, train: bool) -> None:
        """FLOPs and kernel bounds from the reference's layers, at the
        widths of the precision the configuration states (the reference's
        own runs in float32)."""
        b = self.traffic['batch_size']
        self.out['step_flops'] = flops_mod.step_flops(layers, cfg, b, train)
        self.out['kernel_bounds_s'] = kernels_mod.step_bounds(
            cfg, b, layers.norms, layers.deform_flops, train, self.cfg_dict['precision'])

    def _log_kernels(self) -> None:
        """Each port kernel's device time, launches and least time a step."""
        sl, bounds = self.out['slice'], self.out['kernel_bounds_s']
        seen: Dict[str, List[float]] = {}
        for name, start, end in sl['device']:
            k = kernels_mod.kernel_of(name)
            if k is not None:
                seen.setdefault(k, []).append(end - start)
        for k, times in sorted(seen.items()):
            bound = bounds.get(k)
            self.log(f'kernel {k}: {sum(times) * 1e3 / sl["steps"]:.4f} ms and '
                     f'{len(times) / sl["steps"]:g} launches a step, least '
                     f'{"-" if bound is None else f"{bound * 1e3:.4f}"} ms')

    def run(self) -> Dict[str, Any]:
        loop = self.traffic['loop']
        if loop == 'train':
            self.train()
        elif loop == 'predict':
            self.predict()
        else:
            raise ValueError(f'traffic loop {loop!r}: train or predict')
        self.out['loop'] = loop
        self.out['numbers'] = self.numbers
        if self.trace_on:
            self._log_kernels()
        limits = self.spec['limits']
        self.out['correct'] = judge.verdict(self.numbers, limits)
        return self.out

