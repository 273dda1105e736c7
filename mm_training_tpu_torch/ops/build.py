"""Build and load the port's CUDA kernels (``csrc/*.cu``) and its host
libraries (``data/csrc/*.cpp``).

Each kernel source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``; each host
source by ``g++`` (:func:`load_host`). Libraries go to
``mm_training_tpu_torch/_build/``, named by a hash of their source and
flags, so an edited source is rebuilt and an unchanged one is built once per
checkout; a build writes a temporary file and renames it into place, so a
concurrent build never sees half a library. :func:`build_kernels` starts one
``nvcc`` per source at once; :func:`load` and :func:`load_host` build on
first use. Nothing is built at import time. :func:`float_atomics` reads a
built library's SASS (``cuobjdump -sass``) for float atomics.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ['KERNEL_SOURCES', 'build_kernels', 'check', 'float_atomics', 'load', 'load_host',
           'scratch']

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / 'csrc'
BUILD_DIR = PKG / '_build'
KERNEL_SOURCES = ('affine_act', 'affine_act_backward', 'voxelize', 'gaussian_heatmap',
                  'circle_nms', 'lift_splat', 'lift_splat_backward', 'lift_splat_raw',
                  'deform_conv', 'depth_labels', 'bev_warp')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')
GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')
# a float atomic or reduction in SASS, global or shared, any width:
# RED.E.ADD.F32.FTZ.RN.STRONG.GPU, REDG.E.ADD.F32x4..., ATOMS.ADD.F32, ...BF16x2
FLOAT_ATOMIC = re.compile(r'\b(?:ATOM|RED)[GS]?\.\S*\b(?:B?F16|F32|F64)')


def cuda_tool(name: str = 'nvcc') -> str:
    """Path of the CUDA toolkit's ``name`` (``nvcc``, ``cuobjdump``)."""
    found = shutil.which(name)
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and Path(root, 'bin', name).is_file():
            return str(Path(root, 'bin', name))
    raise RuntimeError(f'{name} not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): '
                       'the CUDA kernels need the CUDA toolkit')


def _library_path(source: Path, flags: Sequence[str]) -> Path:
    digest = hashlib.sha256(source.read_bytes() + ' '.join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{source.stem}-{digest}.so'


def _compile(jobs: Dict[str, Tuple[Sequence[str], Path, Path]]) -> None:
    """Run every job {name: (compiler and flags, source, library)} whose
    library is missing, all at once, each into a temporary file renamed into
    place. Raises with the compilers' output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, (compiler, src, lib) in jobs.items():
        if lib.is_file():
            continue
        tmp = lib.with_name(f'{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp')
        procs[n] = (subprocess.Popen([*compiler, '-o', str(tmp), str(src)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp, lib, src)
    failed = []
    for n, (proc, tmp, lib, src) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{src}:\n{out}')
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError('build failed\n' + '\n'.join(failed))


def build_kernels(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every missing kernel library, one ``nvcc`` per source, all at
    once. Returns {name: library path}. Raises with the compiler's output
    when a build fails."""
    libs = {n: _library_path(CSRC / f'{n}.cu', NVCC_FLAGS) for n in names}
    missing = [n for n, lib in libs.items() if not lib.is_file()]
    if missing:
        nvcc = [cuda_tool(), *NVCC_FLAGS]
        _compile({n: (nvcc, CSRC / f'{n}.cu', libs[n]) for n in missing})
    return libs


_HOST_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _load_host(source: Path) -> ctypes.CDLL:
    lib = _library_path(source, GXX_FLAGS)
    try:
        _compile({source.stem: (['g++', *GXX_FLAGS], source, lib)})
    except OSError as e:            # no g++ on PATH
        raise RuntimeError(f'cannot build {source}: {e}') from e
    return ctypes.CDLL(str(lib))


def load_host(source: Path) -> ctypes.CDLL:
    """The loaded library of the host C++ ``source``, built by ``g++`` at
    first use (one build at a time in a process; loader threads call this
    concurrently). Raises naming the source when the build fails: nothing
    falls back."""
    with _HOST_LOCK:
        return _load_host(Path(source).resolve())


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/{name}.cu``, built first if needed."""
    lib = ctypes.CDLL(str(build_kernels((name,))[name]))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def float_atomics(name: str, kernel: str, library: Optional[Path] = None) -> Dict[str, int]:
    """{function: its float atomic instructions} for every function of
    ``csrc/{name}.cu``'s built library (or ``library``) whose mangled name
    holds ``kernel``, read from ``cuobjdump -sass``. Raises when no function
    matches."""
    lib = library or build_kernels((name,))[name]
    sass = subprocess.run([cuda_tool('cuobjdump'), '-sass', str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        head = line.strip()
        if head.startswith('Function : '):
            fn = head[len('Function : '):]
            if kernel in fn:
                counts[fn] = 0
        elif fn in counts and FLOAT_ATOMIC.search(line):
            counts[fn] += 1
    if not counts:
        raise RuntimeError(f'float_atomics: no function {kernel!r} in the SASS of {lib}')
    return counts


# (kernel, device index, stream) -> (float32 scratch, int32 barrier words):
# allocated once, the scratch grown for a larger shape; the words start at
# zero and every launch leaves them so. Calls on one stream run in order,
# so they may share them.
_SCRATCH = {}


def scratch(kernel: str, device, stream: int, floats: int, words: int):
    """(float32 tensor of at least ``floats`` values, int32 tensor of at
    least ``words`` zeros) kept for ``kernel``'s launches on this device
    and stream, so a warm call allocates nothing."""
    key = (kernel, device.index, stream)
    buf, barrier = _SCRATCH.get(key, (None, None))
    if buf is None or buf.numel() < floats:
        buf = torch.empty(floats, dtype=torch.float32, device=device)
    if barrier is None or barrier.numel() < words:
        barrier = torch.zeros(words, dtype=torch.int32, device=device)
    _SCRATCH[key] = (buf, barrier)
    return buf, barrier


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f'{what}: CUDA error {code} '
                           f'({lib.error_string(code).decode()})')
