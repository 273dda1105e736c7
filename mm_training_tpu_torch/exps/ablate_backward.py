"""Where the time of the backward kernels K5' (the DCN's whole backward) and
K4' (the splat's backward) goes, by ablation on the card.

Each variant is a copy of ``csrc/deform_conv.cu`` or
``csrc/lift_splat_backward.cu`` with one phase cut out (its results are
wrong; only its time is read), built by ``nvcc`` into
``_build/ablate/`` and swapped in for the module's library. Each is timed
with :func:`~mm_training_tpu_torch.exps.timing.device_ms` on the same
inputs: K5' at the B=1 and the B=4 ``lidar_cam_radar`` train step's DCN
([4 or 16, 44, 80, 512] bf16, 4 groups) with offsets up to 3 px and at
whole pixels, each of its two kernels' device time split out by
torch.profiler; K4' at the B=1 and B=4 camera splat in both depth layouts.
The ``phase clocks`` variant keeps every phase and adds ``clock64()``
stamps: the cycles block 0's first thread spends in each phase of K5''s d
x kernel (its own work and its waits at the barrier that ends the phase),
summed over its tiles.

    python -m mm_training_tpu_torch.exps.ablate_backward

A variant whose text no longer matches the source raises: update it with
the kernel.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
from typing import Dict, List, Tuple
from unittest import mock

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import lidar_cam_radar
from ..ops import build, deform_conv, voxel_pooling
from .kernel_inputs import deform_inputs, deform_shape, splat_inputs
from .timing import device_ms

__all__ = ['DEFORM_VARIANTS', 'SPLAT_VARIANTS', 'main']

Patch = List[Tuple[str, str]]

DEFORM_VARIANTS: Dict[str, Patch] = {
    'kernels as built': [],
    'no d cols products': [
        ('DCols<T>::run(dys, ws + buf * TPS * KC * L::DS, dcs, og);', '')],
    'no offset dots': [
        ('          for (int e = 0; e < 8; ++e) dot[k] = fmaf(d8[e], x8[e], dot[k]);', '')],
    'no d x gather': [
        ('          for (int i = 0; i < 8; ++i) gx[j][i] = fmaf(cw, d8[i], gx[j][i]);', '')],
    'no weight products': [('    acc.contract(As, dys, og);', '')],
    'phase clocks': [
        ('// [NB] while the buckets are made\n',
         '// [NB] while the buckets are made\n'
         '  long long clk[6] = {0, 0, 0, 0, 0, 0}, c0k = 0;\n'),
        ('    __syncthreads();   // the last tile is done with shared memory\n'
         '    for (int i = tid; i < NB; i += THREADS) cnt[i] = 0;',
         '    __syncthreads();   // the last tile is done with shared memory\n'
         '    c0k = clock64();\n'
         '    for (int i = tid; i < NB; i += THREADS) cnt[i] = 0;'),
        ('    __syncthreads();   // the buckets are made; the W buffers are free again',
         '    __syncthreads();   // the buckets are made; the W buffers are free again\n'
         '    clk[0] += clock64() - c0k;'),
        ('      cp_async_wait_all();\n'
         "      __syncthreads();   // this step's copies landed; the last step's readers are done",
         '      c0k = clock64();\n'
         '      cp_async_wait_all();\n'
         "      __syncthreads();   // this step's copies landed; the last step's readers are done\n"
         '      clk[1] += clock64() - c0k; c0k = clock64();'),
        ("      __syncthreads();   // the step's d cols; dY is free",
         "      __syncthreads();   // the step's d cols; dY is free\n"
         '      clk[2] += clock64() - c0k; c0k = clock64();'),
        ('      if (chunk_end) {\n'
         '        __syncthreads();   // every thread is done with the halo',
         '      clk[3] += clock64() - c0k; c0k = clock64();\n'
         '      if (chunk_end) {\n'
         '        __syncthreads();   // every thread is done with the halo'),
        ('      // d x inside the halo: each (halo pixel, 8 channels) this thread owns',
         '      clk[4] += clock64() - c0k; c0k = clock64();\n'
         '      // d x inside the halo: each (halo pixel, 8 channels) this thread owns'),
        ('      if (chunk_end) {\n'
         "        // the chunk's d x: into device memory",
         '      clk[5] += clock64() - c0k; c0k = clock64();\n'
         '      if (chunk_end) {\n'
         "        // the chunk's d x: into device memory"),
        ('  grid_barrier(p.barrier);\n\n  // --- 2: d x rounded once to bf16',
         '  if (blockIdx.x == 0 && tid == 0)\n'
         '    for (int i = 0; i < 6; ++i) p.doff[i] = (float)clk[i];\n'
         '  grid_barrier(p.barrier);\n\n  // --- 2: d x rounded once to bf16'),
    ],
}
CLOCK_PHASES = ('table and buckets', 'step start: copies and the last flush',
                'd cols products', 'offset dots (and d x beyond the halo)',
                'chunk end: halo free', 'd x gather')

SPLAT_VARIANTS: Dict[str, Patch] = {
    'kernels as built': [],
    'no products': [('    prod.tile(ctx_s, g_s + buf * kBD * S::CS',
                     '    if (0) prod.tile(ctx_s, g_s + buf * kBD * S::CS')],
    'no zvalid reads': [('        zr[u] = __ldg(zv + (di * fh + hh) * p.fw);',
                         '        zr[u] = 1;')],
    'no depth reads': [('        dv[u] = depth[di * p.sdd + (int64_t)hh * p.sdh];',
                        '        dv[u] = from_float<T>(0.5f);')],
    'no g rows': [('      copy_g(cell_next, buf ^ 1);\n', '')],
}


def build_variants(source: str, variants: Dict[str, Patch]) -> Dict[str, ctypes.CDLL]:
    """{variant: its library}, one nvcc per variant, all at once."""
    text = (build.CSRC / f'{source}.cu').read_text()
    out_dir = build.BUILD_DIR / 'ablate'
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, patch) in enumerate(variants.items()):
        s = text
        for old, new in patch:
            if s.count(old) != 1:
                raise ValueError(f'{source} variant {name!r}: {old[:60]!r} matches '
                                 f'{s.count(old)} times in the source')
            s = s.replace(old, new)
        src, lib = out_dir / f'{source}_{i}.cu', out_dir / f'{source}_{i}.so'
        src.write_text(s)
        procs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, '-o', str(lib),
                                         str(src)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'{source} variant {name!r} failed to build:\n{log}')
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _like(lib: ctypes.CDLL, ref: ctypes.CDLL, names) -> ctypes.CDLL:
    for n in names:
        getattr(lib, n).argtypes = getattr(ref, n).argtypes
        getattr(lib, n).restype = getattr(ref, n).restype
    return lib


def _kernel_ms(fn, keys, iters: int = 5) -> dict:
    """Device ms of one call of ``fn`` by kernel (names containing ``keys``)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name == 'CUDA':
            k = next((k for k in keys if k in e.key), e.key[:40])
            out[k] = out.get(k, 0.0) + e.self_device_time_total / 1e3 / iters
    return out


def main() -> List[dict]:
    if not torch.cuda.is_available():
        raise SystemExit('ablate_backward: needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({'card': card}), flush=True)
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = []
    dcn_libs = build_variants('deform_conv', DEFORM_VARIANTS)
    ref = deform_conv._lib()
    dcn = {}
    for b in (1, 4):
        shape = deform_shape(lidar_cam_radar(batch_size=b))
        for reach in (3.0, 0.0):
            x, off, wgt, bias = deform_inputs(shape, 4, gen, torch.bfloat16, reach)
            dy = torch.randn(*shape[:3], wgt.shape[0] * wgt.shape[2], generator=gen,
                             device='cuda').bfloat16()
            dcn[(b, reach)] = (dy, x, off, wgt, bias, 4)
    names = ('deform_conv3x3_backward', 'deform_conv3x3_backward_scratch', 'error_string')
    for name, lib in dcn_libs.items():
        with mock.patch.object(deform_conv, '_lib', lambda lib=_like(lib, ref, names): lib):
            for (b, reach), args in dcn.items():
                def fn(args=args):
                    return deform_conv.deform_conv3x3_backward(*args)
                row = {'kernel': 'deform_conv3x3_backward', 'variant': name, 'batch_size': b,
                       'offsets_px': reach, 'ms': device_ms(fn, 10),
                       'by_kernel_ms': _kernel_ms(fn, ('deform_bwd_input', 'deform_bwd_weight'))}
                if name == 'phase clocks':
                    row['block0_cycles'] = dict(zip(CLOCK_PHASES, fn()[1][0, 0, 0, :6].tolist()))
                rows.append(row)
                print(json.dumps(row), flush=True)
    splat_libs = build_variants('lift_splat_backward', SPLAT_VARIANTS)
    ref = voxel_pooling._lib_backward()
    for name, lib in splat_libs.items():
        lib = _like(lib, ref, ('lift_splat_backward', 'error_string'))
        with mock.patch.object(voxel_pooling, '_lib_backward', lambda lib=lib: lib):
            for b in (1, 4):
                for layout in ('channels_last', 'nchw'):
                    args = splat_inputs(lidar_cam_radar(batch_size=b), gen, layout)
                    g = torch.randn(args[2].shape[0], args[4], args[1].shape[-1], generator=gen,
                                    device='cuda').bfloat16()
                    row = {'kernel': 'lift_splat_factorized_backward', 'variant': name,
                           'batch_size': b, 'layout': layout,
                           'ms': device_ms(lambda: voxel_pooling.lift_splat_factorized_backward(
                               g, *args), 20)}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    return rows


if __name__ == '__main__':
    main()
