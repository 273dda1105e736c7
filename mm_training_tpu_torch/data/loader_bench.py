"""Host data-path throughput: can the host feed the card?

The port of ``mm_training_tpu/data/loader_bench.py``. It measures the real
host path at production shapes: 4 JPEGs of 704 x 1280 decoded by the
port's own codec (two of them Mei fisheyes virtualized to pinholes by
``data/image.py::remap_linear``), the point cloud read with its ego-motion
aggregation and the radar's polar-to-Cartesian, the augmentation, the
native point packing and the fixed-shape collate: the whole
``AiMotiveDataset`` / ``PrefetchLoader`` chain the trainer consumes.

The fixture is synthetic (``generate_synthetic_dataset``) but scaled to
production cost: ~100k-point clouds and high-entropy JPEGs
(``image_detail=True``; smooth synthetic images decode ~3x faster than
real photos). With ``--laz`` the LiDAR frames are LASzip files decoded by
the native codec (``data/lasio.py``) in the hot loop, the on-disk format
of the real dataset; the default is ``.npy`` (the decoded-cache regime).

The bar: the loader's samples/s must reach the card's training rate,
which the caller passes as ``--device-rate`` (samples/s of the train step
on the card; ``PERF.md`` gives it with the card's name).

    python -m mm_training_tpu_torch.data.loader_bench --device-rate R
        [--root DIR] [--laz] [--sweep] [--img-hw 704 1280] [--ground-points 100000]

Also the timing helpers the loader profiles share
(``exps/profile_loader.py``): :func:`mean_ms`, :func:`stage_clock` and
:func:`loader_samples_per_s`.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

__all__ = ['bench_config', 'build_fixture', 'loader_samples_per_s', 'main', 'mean_ms',
           'measure_getitem_ms', 'measure_loader_sps', 'mirror_fixture_as_laz',
           'stage_clock']

# fixture geometry: big enough that one epoch is not one warm file, small
# enough to write in seconds
_FIXTURE_FRAMES = 8
_FIXTURE_SEQS = 2
_FIXTURE_MARKER = 'loader_bench_fixture.json'


def mean_ms(fn, items) -> float:
    """Host ms a call of ``fn`` over ``items``, one at a time."""
    t0 = time.perf_counter()
    for x in items:
        fn(x)
    return (time.perf_counter() - t0) * 1e3 / len(items)


@contextlib.contextmanager
def stage_clock(module, name: str):
    """While the block runs, time every call of ``module.name`` (a stage
    inside the calls being timed) and collect its seconds in the yielded
    list. The stage's intervals lie inside the enclosing timing's, on the
    same clock, so their sum never exceeds it."""
    fn = getattr(module, name)
    spent = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent.append(time.perf_counter() - t0)

    setattr(module, name, timed)
    try:
        yield spent
    finally:
        setattr(module, name, fn)


def loader_samples_per_s(loader, batches: Optional[int] = None, warmup: int = 0) -> float:
    """Samples/s of ``loader``: the samples of ``batches`` batches (all of
    an epoch when None) after ``warmup`` batches, over as many epochs as
    that takes (``set_epoch`` between them)."""
    done, count, t0 = 0, 0, None
    if warmup == 0:
        t0 = time.perf_counter()
    for epoch in range(1000):
        loader.set_epoch(epoch)
        for batch in loader:
            done += 1
            if done == warmup:
                t0 = time.perf_counter()
            elif done > warmup:
                count += batch['points'].shape[0]
                if batches is not None and done - warmup >= batches:
                    return count / (time.perf_counter() - t0)
        if batches is None:
            return count / (time.perf_counter() - t0)
    raise RuntimeError('fixture too small for the requested batch count')


def build_fixture(root: str, img_hw=(704, 1280), n_ground_points: int = 100_000,
                  lidar_format: str = 'npy') -> str:
    """Write (or reuse) the production-shape fixture under ``root``: 2
    sequences of 8 frames with the two fisheyes, ``image_detail`` JPEGs.
    ``lidar_format='laz'`` writes LASzip frames."""
    from .synthetic import generate_synthetic_dataset

    spec = {'img_hw': list(img_hw), 'n_ground_points': n_ground_points,
            'frames': _FIXTURE_FRAMES, 'seqs': _FIXTURE_SEQS, 'version': 2}
    if lidar_format != 'npy':
        spec['lidar_format'] = lidar_format
    marker = os.path.join(root, _FIXTURE_MARKER)
    if _marker_is(marker, spec):
        return root
    generate_synthetic_dataset(
        root, splits=('train',), odds=('highway',), sequences_per_odd=_FIXTURE_SEQS,
        frames_per_sequence=_FIXTURE_FRAMES, n_objects=8, img_hw=tuple(img_hw),
        fisheyes=True, n_ground_points=n_ground_points, image_detail=True,
        lidar_format=lidar_format)
    with open(marker, 'w') as f:
        json.dump(spec, f)
    return root


def _marker_is(marker: str, spec: dict) -> bool:
    try:
        with open(marker) as f:
            return json.load(f) == spec
    except (OSError, ValueError):
        return False


def mirror_fixture_as_laz(src_root: str, dst_root: str) -> str:
    """The LAZ twin of an ``.npy`` fixture: the images, annotations and
    calibration linked, only the LiDAR frames converted to LASzip files
    (the JPEGs dominate the cost of writing a second fixture)."""
    from . import lasio

    with open(os.path.join(src_root, _FIXTURE_MARKER)) as f:
        spec = json.load(f)
    spec['lidar_format'] = 'laz-mirror'
    marker = os.path.join(dst_root, _FIXTURE_MARKER)
    if _marker_is(marker, spec):
        return dst_root
    for dirpath, _, filenames in os.walk(src_root):
        rel = os.path.relpath(dirpath, src_root)
        dst_dir = os.path.join(dst_root, rel)
        os.makedirs(dst_dir, exist_ok=True)
        for name in filenames:
            if rel == '.' and name == _FIXTURE_MARKER:
                continue
            src, dst = os.path.join(dirpath, name), os.path.join(dst_dir, name)
            if name.endswith('.npy') and os.path.basename(dirpath) == 'raw-revolutions':
                laz = dst[:-4] + '.laz'
                if not os.path.exists(laz):
                    lasio.write_las(laz, np.load(src).astype(np.float64))
            elif not os.path.exists(dst):
                os.symlink(src, dst)
    with open(marker, 'w') as f:
        json.dump(spec, f)
    return dst_root


def bench_config(img_hw=(704, 1280)):
    """The full production host path: ``lidar_cam_radar`` with the fisheyes
    virtualized (6 cameras: front, back, two a fisheye), as the reference
    always virtualizes its two Mei cameras; images of ``img_hw``."""
    from ..configs import variants
    return variants.lidar_cam_radar(batch_size=2, virtualize_fisheyes=True, num_cameras=6,
                                    max_points_per_frame=100_000, H=img_hw[0], W=img_hw[1])


def _dataset(root: str, cfg=None):
    from .aimotive_dataset import AiMotiveDataset
    return AiMotiveDataset(root, cfg if cfg is not None else bench_config(), split='train')


def measure_getitem_ms(root: str, iters: int = 6, cfg=None) -> float:
    """Host ms of one ``dataset[i]`` on one thread: the floor one worker
    pays a sample (the first call, which warms the remap tables and the
    page cache, not counted)."""
    ds = _dataset(root, cfg)
    ds[0]
    return mean_ms(ds.__getitem__, [(i + 1) % len(ds) for i in range(iters)])


def measure_loader_sps(root: str, batch_size: int = 2, num_workers: int = 8,
                       batches: int = 12, warmup: int = 3, worker_mode: str = 'thread',
                       cfg=None) -> float:
    """Sustained ``PrefetchLoader`` samples/s (shuffled, ``batches`` batches
    after ``warmup``): the number that must reach the card's train rate."""
    from ..training.loader import PrefetchLoader

    loader = PrefetchLoader(_dataset(root, cfg), batch_size=batch_size, shuffle=True,
                            num_workers=num_workers, seed=0, drop_last=False,
                            worker_mode=worker_mode)
    try:
        return loader_samples_per_s(loader, batches, warmup)
    finally:
        loader.close()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device-rate', type=float, required=True,
                    help="the card's train samples/s the loader must reach")
    ap.add_argument('--root', default=None,
                    help='fixture directory (reused when its marker matches); '
                         'default: a temporary one')
    ap.add_argument('--batches', type=int, default=12)
    ap.add_argument('--num-workers', type=int, default=8)
    ap.add_argument('--batch-size', type=int, default=2)
    ap.add_argument('--img-hw', type=int, nargs=2, default=[704, 1280])
    ap.add_argument('--ground-points', type=int, default=100_000)
    ap.add_argument('--sweep', action='store_true',
                    help='also sweep worker counts and the process mode')
    ap.add_argument('--laz', action='store_true',
                    help='a LASzip LiDAR fixture (the native codec in the hot loop) '
                         'in place of .npy')
    args = ap.parse_args(argv)

    with contextlib.ExitStack() as stack:
        root = args.root or stack.enter_context(tempfile.TemporaryDirectory())
        build_fixture(root, tuple(args.img_hw), args.ground_points)
        if args.laz:
            root = mirror_fixture_as_laz(root, root.rstrip('/') + '_laz')
            if not args.root:
                stack.callback(shutil.rmtree, root, True)
        cfg = bench_config(tuple(args.img_hw))
        sps = measure_loader_sps(root, args.batch_size, args.num_workers, args.batches, cfg=cfg)
        out = {
            'loader_sps': sps,
            'getitem_ms': measure_getitem_ms(root, cfg=cfg),
            'lidar_format': 'laz' if args.laz else 'npy',
            'num_workers': args.num_workers,
            'batch_size': args.batch_size,
            'img_hw': list(args.img_hw),
            'host_cpus': os.cpu_count(),
            'device_rate_to_beat': args.device_rate,
            'feeds_device': sps >= args.device_rate,
        }
        if args.sweep:
            out['thread_sweep'] = {nw: measure_loader_sps(root, num_workers=nw,
                                                          batches=args.batches, cfg=cfg)
                                   for nw in (1, 2, 4, 8)}
            out['process_sps'] = measure_loader_sps(root, num_workers=args.num_workers,
                                                    batches=args.batches,
                                                    worker_mode='process', cfg=cfg)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
