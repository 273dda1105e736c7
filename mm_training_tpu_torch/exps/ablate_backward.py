"""Where the time of the kernels K5' (the DCN's whole backward), K4' (the
splat's backward), K8 / K8' (the raw-rig splat and its backward) and K1's
sparse-input mode goes, by ablation on the card.

Each variant is a copy of ``csrc/deform_conv.cu``,
``csrc/lift_splat_backward.cu``, ``csrc/lift_splat_raw.cu`` or
``csrc/voxelize.cu`` with one phase cut out (its results are wrong; only
its time is read), built by
``nvcc`` into ``_build/ablate/`` and swapped in for the module's library.
Each is timed with :func:`~mm_training_tpu_torch.exps.timing.device_ms` on
the same inputs: K5' at the B=1 and the B=4 ``lidar_cam_radar`` train
step's DCN ([4 or 16, 44, 80, 512] bf16, 4 groups) with offsets up to 3 px
and at whole pixels, each of its two kernels' device time split out by
torch.profiler; K4' at the B=1 and B=4 camera splat in both depth layouts;
K8 and K8' at the B=1 and B=4 raw-rig splat (the fake rig pitched by 3
degrees, bf16) in both depth layouts, with the interval statistics of the
rig's cells (entries a cell: max, p99, mean). The ``phase clocks``
variants keep every phase and add timer stamps: for K5''s d x kernel the
cycles block 0's first thread spends in each phase (its own work and its
waits at the barrier that ends the phase), summed over its tiles; for K8
the global timer at each of its grid barriers and at the last block's
end, the grid's time in each of its five phases; for K1's sparse mode the
same at its three barriers, at B=1 and B=4 on LiDAR-like, uniform and
crowded frames (``sparse_inputs``), bf16, cap 15.

    python -m mm_training_tpu_torch.exps.ablate_backward [--only raw_splat sparse_input]

A variant whose text no longer matches the source raises: update it with
the kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple
from unittest import mock

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import lidar_cam_radar, lidar_radar
from ..data import make_fake_batch
from ..ops import build, deform_conv, voxel_pooling, voxelize
from .kernel_inputs import (deform_inputs, deform_shape, lidar_like_points, raw_interval_stats,
                            raw_splat_inputs, splat_inputs)
from .timing import device_ms

__all__ = ['DEFORM_VARIANTS', 'RAW_SPLAT_VARIANTS', 'SECTIONS', 'SPARSE_VARIANTS',
           'SPLAT_VARIANTS', 'main', 'sparse_inputs']

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


# K8 and K8' (csrc/lift_splat_raw.cu); a cut store stays behind a test on
# a value the data never holds, so the compiler keeps what feeds it.
# 'phase clocks' keeps every phase and stamps the global timer at K8's grid
# barriers (block 0) and at each block's end (the latest), read back by
# read_phase_clocks: the grid's time in each phase.
RAW_SPLAT_VARIANTS: Dict[str, Patch] = {
    'kernels as built': [],
    'phase clocks': [
        ('namespace {\n\nconstexpr int kThreads = 256;',
         '__device__ unsigned long long g_clk[8];\n'
         '__device__ __forceinline__ unsigned long long gtime() {\n'
         '  unsigned long long t;\n'
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
         '  return t;\n'
         '}\n\n'
         'namespace {\n\nconstexpr int kThreads = 256;'),
        ('  // --- (a) count the kept rows of each cell\n',
         '  if (blockIdx.x == 0 && tid == 0) { g_clk[0] = gtime(); g_clk[5] = 0; }\n'
         '  // --- (a) count the kept rows of each cell\n'),
        ('  grid_barrier(p.barrier);\n\n  // --- (b) scan',
         '  grid_barrier(p.barrier);\n  if (blockIdx.x == 0 && tid == 0) g_clk[1] = gtime();\n\n'
         '  // --- (b) scan'),
        ('  if (tid == 0) p.block_sums[blockIdx.x] = s;\n  grid_barrier(p.barrier);',
         '  if (tid == 0) p.block_sums[blockIdx.x] = s;\n  grid_barrier(p.barrier);\n'
         '  if (blockIdx.x == 0 && tid == 0) g_clk[2] = gtime();'),
        ('  grid_barrier(p.barrier);\n\n  // --- (c) scatter',
         '  grid_barrier(p.barrier);\n  if (blockIdx.x == 0 && tid == 0) g_clk[3] = gtime();\n\n'
         '  // --- (c) scatter'),
        ('  grid_barrier(p.barrier);\n\n  // --- (d) gather',
         '  grid_barrier(p.barrier);\n  if (blockIdx.x == 0 && tid == 0) g_clk[4] = gtime();\n\n'
         '  // --- (d) gather'),
        ('  if (p.adds) {\n    if (kept_rows)',
         '  __syncthreads();\n  if (tid == 0) atomicMax(&g_clk[5], gtime());\n'
         '  if (p.adds) {\n    if (kept_rows)'),
        ('extern "C" const char* error_string(int code) {',
         'extern "C" int read_phase_clocks(unsigned long long* out) {\n'
         '  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n'
         '}\n\n'
         'extern "C" const char* error_string(int code) {')],
    'K8 no ctx gathers': [
        ('          cr[v] = ok ? load_row(cm + pix * scp, scc, true) : splat_row(from_float<T>(0.f));',
         '          cr[v] = splat_row(from_float<T>((float)(pix & 7)));')],
    'K8 no depth reads': [
        ('      tile[b * kPad + x] = in ? to_float(dm[(d0 + b) * p.sdd + (int64_t)(p0 + x) * p.sdp]) '
         ': 0.f;',
         '      tile[b * kPad + x] = in ? 0.5f : 0.f;')],
    "K8' no g gathers": [
        ('                    ? load_row(g + (int64_t)cell[u] * p.sgg, 1, vec) : splat_row(zero);',
         '                    ? cr : splat_row(zero);')],
    "K8' no d depth combine": [
        ('      dd[(d0 + b) * p.sed + (int64_t)(p0 + x) * p.sep] = from_float<T>(v);',
         '      if (v == 1.2345e-38f) dd[(d0 + b) * p.sed + (int64_t)(p0 + x) * p.sep] = '
         'from_float<T>(v);')],
    "K8' no trash vote": [
        ('      if (!any) continue;   // no pixel of the block keeps these bins\n', ''),
        ('        if (!((any >> u) & 1u)) continue;\n', '')],
}
RAW_CLOCK_PHASES = ('(a) count', '(b) sum segments', '(b) scan', '(c) scatter', '(d) gather')

# K1's sparse-input mode (csrc/voxelize.cu, sparse_kernel): 'phase clocks'
# stamps the global timer at the kernel's start and after each grid barrier
# (block 0) and at each block's end (the latest), read back by
# read_phase_clocks: the grid's time in each phase. 'no zero rows' skips
# the zero rows of the empty pillars (phase 2's output stream), 'no small
# pillars' the pillars of at most four points.
SPARSE_CLOCK_PHASES = ('1 count', '2 occupancy, zero rows, intervals, small pillars',
                       '3 fill the intervals', '4 queued pillars')
_SPARSE_STAMPS = ('  grid_barrier(p.barrier);\n\n  // --- 2: every pillar',
                  '  grid_barrier(p.barrier);\n\n  // --- 3: each later arrival',
                  '  grid_barrier(p.barrier);\n\n  // --- 4: the queued pillars')
SPARSE_VARIANTS: Dict[str, Patch] = {
    'kernels as built': [],
    'phase clocks': [
        ('namespace {\n\nconstexpr int kThreads = 256;',
         '__device__ unsigned long long g_clk[8];\n'
         '__device__ __forceinline__ unsigned long long gtime() {\n'
         '  unsigned long long t;\n'
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
         '  return t;\n'
         '}\n\n'
         'namespace {\n\nconstexpr int kThreads = 256;'),
        ("  // --- 1: count; each point's pillar and arrival ordinal\n",
         f'  if (blockIdx.x == 0 && tid == 0) {{ g_clk[0] = gtime(); '
         f'g_clk[{len(SPARSE_CLOCK_PHASES)}] = 0; }}\n'
         "  // --- 1: count; each point's pillar and arrival ordinal\n"),
        *((old, old.replace('grid_barrier(p.barrier);\n',
                            'grid_barrier(p.barrier);\n'
                            f'  if (blockIdx.x == 0 && tid == 0) g_clk[{i + 1}] = gtime();\n', 1))
          for i, old in enumerate(_SPARSE_STAMPS)),
        ('    warp_pillar<T>(p, __ldcg(p.wlist + q), lane);\n}\n',
         '    warp_pillar<T>(p, __ldcg(p.wlist + q), lane);\n  __syncthreads();\n'
         f'  if (tid == 0) atomicMax(&g_clk[{len(SPARSE_CLOCK_PHASES)}], gtime());\n}}\n'),
        ('extern "C" const char* error_string(int code) {',
         'extern "C" int read_phase_clocks(unsigned long long* out) {\n'
         '  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n'
         '}\n\n'
         'extern "C" const char* error_string(int code) {')],
    'no zero rows': [('      if (n == 0) zero_row<T>(p, o);\n', '')],
    'no small pillars': [('      if (n <= kInline) small_pillar<T>(p, sl.x, n);\n', '')],
}
SECTIONS = ('deform_backward', 'splat_backward', 'raw_splat', 'sparse_input')


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
        procs[name] = (subprocess.Popen([build.cuda_tool(), *build.NVCC_FLAGS, '-o', str(lib),
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


def _deform_rows(gen) -> List[dict]:
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
    return rows


def _splat_rows(gen) -> List[dict]:
    rows = []
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


def _raw_splat_rows(gen) -> List[dict]:
    """K8 and K8' of every variant at the B=1 and B=4 raw-rig splat, both
    depth layouts, the same inputs for every variant; first the interval
    statistics of each batch size's cells."""
    rows = []
    inputs = {}
    for b in (1, 4):
        for layout in ('channels_last', 'nchw'):
            args = raw_splat_inputs(lidar_cam_radar(batch_size=b), gen, layout)
            g = torch.randn(args[2].shape[0], args[3], args[1].shape[-1], generator=gen,
                            device='cuda').bfloat16()
            inputs[(b, layout)] = (args, g)
        row = {'kernel': 'lift_splat', 'batch_size': b,
               'intervals': raw_interval_stats(*inputs[(b, 'nchw')][0][2:])}
        rows.append(row)
        print(json.dumps(row), flush=True)
    libs = build_variants('lift_splat_raw', RAW_SPLAT_VARIANTS)
    ref = voxel_pooling._lib_raw()
    names = ('lift_splat_raw', 'lift_splat_raw_workspace', 'lift_splat_raw_backward',
             'error_string')
    for name, lib in libs.items():
        lib = _like(lib, ref, names)
        with mock.patch.object(voxel_pooling, '_lib_raw', lambda lib=lib: lib):
            for (b, layout), (args, g) in inputs.items():
                row = {'variant': name, 'batch_size': b, 'layout': layout,
                       'K8_ms': device_ms(lambda: voxel_pooling.lift_splat(*args), 20),
                       "K8'_ms": device_ms(lambda: voxel_pooling.lift_splat_backward(g, *args),
                                           20)}
                if name == 'phase clocks':
                    voxel_pooling.lift_splat(*args)
                    torch.cuda.synchronize()
                    clk = (ctypes.c_ulonglong * 8)()
                    build.check(lib, lib.read_phase_clocks(clk), 'read_phase_clocks')
                    row['K8_phase_ms'] = {ph: (clk[i + 1] - clk[i]) / 1e6
                                          for i, ph in enumerate(RAW_CLOCK_PHASES)}
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def sparse_inputs(batch_sizes=(1, 4)) -> Dict[Tuple[int, str], tuple]:
    """{(batch size, frame): (points, mask)} on the card: ``lidar_radar``
    frames of 100k points, LiDAR-like, uniform (``make_fake_batch``) and
    LiDAR-like with 20,000 points of each frame in one pillar."""
    cfg = lidar_radar(max_points_per_frame=100_000)
    out = {}
    for b in batch_sizes:
        for kind in ('lidar_like', 'uniform', 'crowded'):
            if kind == 'uniform':
                batch = make_fake_batch(cfg, batch_size=b, seed=b)
                out[(b, kind)] = (torch.as_tensor(batch['points'], device='cuda'),
                                  torch.as_tensor(batch['point_mask'], device='cuda'))
            else:
                out[(b, kind)] = lidar_like_points(cfg, b, seed=b,
                                                   crowd=20_000 if kind == 'crowded' else 0)
    return out


def _sparse_rows() -> List[dict]:
    """K1's sparse mode of every variant at B=1 and B=4 on each frame of
    :func:`sparse_inputs`, bf16 into the sparse encoder's 16 channels, the
    cap of ``lidar_radar`` (15); the phase clocks the median of 5 calls."""
    cfg = lidar_radar()
    geo = (cfg.point_cloud_range, cfg.voxel_size, cfg.out_shape)
    vconf = cfg.get_lidar_conf().voxelization
    inputs = sparse_inputs()
    libs = build_variants('voxelize', SPARSE_VARIANTS)
    ref = voxelize._lib()
    rows = []
    for name, lib in libs.items():
        lib = _like(lib, ref, ('pillar_encoder_input', 'sparse_encoder_input',
                               'sparse_encoder_input_workspace', 'error_string'))
        with mock.patch.object(voxelize, '_lib', lambda lib=lib: lib):
            for (b, kind), (pts, mask) in inputs.items():
                def fn(pts=pts, mask=mask):
                    return voxelize.sparse_encoder_input(
                        pts, mask, *geo, vconf.num_features, torch.bfloat16, 16,
                        max_points_per_voxel=vconf.max_num_points)
                row = {'kernel': 'sparse_encoder_input', 'variant': name, 'batch_size': b,
                       'frame': kind, 'ms': device_ms(fn, 20)}
                if name == 'phase clocks':
                    calls = []
                    for _ in range(5):
                        fn()
                        torch.cuda.synchronize()
                        clk = (ctypes.c_ulonglong * 8)()
                        build.check(lib, lib.read_phase_clocks(clk), 'read_phase_clocks')
                        calls.append([(clk[i + 1] - clk[i]) / 1e6
                                      for i in range(len(SPARSE_CLOCK_PHASES))])
                    row['phase_ms'] = {ph: sorted(c[i] for c in calls)[2]
                                       for i, ph in enumerate(SPARSE_CLOCK_PHASES)}
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--only', nargs='+', choices=SECTIONS, default=SECTIONS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('ablate_backward: needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({'card': card}), flush=True)
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = []
    if 'deform_backward' in args.only:
        rows += _deform_rows(gen)
    if 'splat_backward' in args.only:
        rows += _splat_rows(gen)
    if 'raw_splat' in args.only:
        rows += _raw_splat_rows(gen)
    if 'sparse_input' in args.only:
        rows += _sparse_rows()
    return rows


if __name__ == '__main__':
    main()
