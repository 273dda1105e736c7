"""Host data loading: shuffling, threaded prefetch, fixed-shape batches.

The port's copy of ``mm_training_tpu/training/loader.py``, which replaces
the torch DataLoader workers of the reference (mm_training_aim.py:533-565,
num_workers=8): the same batch plan (the shuffle RNG, ``drop_last``,
``pad_last`` with ``n_valid`` and ``sample_valid``, ``skip_batches``), so
the port's batches equal the JAX loader's on the same dataset and seed.
numpy and the native codec release the GIL for the heavy work, so a
thread pool keeps the card fed; batches are plain numpy dicts (the trainer
copies them to the card, ``training/trainer.py::_device_batches``).

``worker_mode='process'`` forks a persistent worker pool (the torch
num_workers equivalent); samples come back through pickle. The workers run
the dataset's numpy and native code only, never torch or CUDA, so a fork
after CUDA is initialised is safe for them.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np

from ..data.aimotive_dataset import collate_aim

__all__ = ['PrefetchLoader', 'stack_batches']

# process-worker state: set once per forked child (fork inherits the parent
# dataset copy-on-write; tasks then carry only (index, epoch) ints)
_WORKER_DS = None


def _init_worker(ds):
    global _WORKER_DS
    _WORKER_DS = ds


def _load_indexed(task):
    index, epoch = task
    if (hasattr(_WORKER_DS, 'set_epoch')
            and getattr(_WORKER_DS, 'epoch', None) != epoch):
        _WORKER_DS.set_epoch(epoch)  # parent's set_epoch can't reach us
    return _WORKER_DS[index]


def stack_batches(batches):
    """Stack K host batches on a new leading axis for K-step dispatch
    (train_step.make_train_step_multi). Non-array fields (e.g. 'path')
    become lists."""
    out = {}
    for k in batches[0]:
        vals = [b[k] for b in batches]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    return out


class PrefetchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 4, pad_last: bool = False,
                 process_rows: Optional[Tuple[int, int]] = None,
                 worker_mode: str = 'thread'):
        """With ``pad_last`` (eval loaders), a short trailing batch is padded
        to full size by repeating its last sample and carries an 'n_valid'
        host-only count — fixed shapes, no dropped eval frames.

        ``process_rows`` (lo, hi): a data-parallel rank loads only rows
        [lo, hi) of each global batch (``parallel.process_batch_bounds``),
        the port of Lightning's DistributedSampler. The plan of global
        batches (the shuffle's seed and epoch, the padding of the trailing
        eval batch to the global size) is the same on every rank, so the
        ranks load disjoint slices of it. ``batch_size`` is the global
        batch; 'n_valid' and 'sample_valid' count the slice (a rank may hold
        only padding rows of a trailing batch), 'n_valid_global' the global
        batch's valid samples, which weight the pooled eval losses."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pad_last = pad_last
        self.process_rows = process_rows
        if worker_mode not in ('thread', 'process'):
            raise ValueError(f'worker_mode {worker_mode!r}')
        self.worker_mode = worker_mode
        self.epoch = 0
        self._start_batch = 0
        # one long-lived pool (a per-batch pool would churn threads);
        # the process pool is created lazily so merely constructing a
        # loader never forks (a fork inherits the parent's threads — safe
        # for numpy-only children, but don't pay it unless iterated)
        self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        self._ppool = None

    def _process_pool(self):
        if self._ppool is None:
            import multiprocessing
            ctx = multiprocessing.get_context('fork')
            self._ppool = ctx.Pool(self.num_workers,
                                   initializer=_init_worker,
                                   initargs=(self.dataset,))
        return self._ppool

    def close(self):
        """Release worker pools (idempotent)."""
        self._pool.shutdown(wait=False)
        if self._ppool is not None:
            self._ppool.terminate()
            self._ppool = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, 'set_epoch'):
            self.dataset.set_epoch(epoch)

    def skip_batches(self, n: int):
        """The NEXT iteration starts at batch ``n`` of the epoch's
        deterministic batch plan (then resets to 0). Mid-epoch resume: the
        skipped batches are never loaded — the index plan is sliced, so
        fast-forwarding costs no IO (Lightning restores the loader position
        from the checkpoint the same way)."""
        self._start_batch = n

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 9973 + self.epoch)
            rng.shuffle(idx)
        nb = len(self)
        for b in range(nb):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def __iter__(self) -> Iterator[dict]:
        batches = list(self._batches())[self._start_batch:]
        self._start_batch = 0
        if not batches:
            return iter(())

        def load_batch(indices):
            n_valid = len(indices)
            if self.pad_last and n_valid < self.batch_size:
                indices = np.concatenate(
                    [indices, np.repeat(indices[-1:],
                                        self.batch_size - n_valid)])
            valid_rows = np.arange(self.batch_size) < n_valid
            if self.process_rows is not None:
                lo, hi = self.process_rows
                indices = indices[lo:hi]
                valid_rows = valid_rows[lo:hi]
            if self.worker_mode == 'process':
                samples = self._process_pool().map(
                    _load_indexed, [(int(i), self.epoch) for i in indices])
            else:
                samples = list(self._pool.map(self.dataset.__getitem__,
                                              indices))
            batch = collate_aim(samples)
            if self.pad_last:
                # the slice's count for per-row consumers (mAP, the export),
                # the global count for the pooled loss means
                batch['n_valid'] = int(valid_rows.sum())
                batch['n_valid_global'] = n_valid
                # device-side validity: the eval step excludes padded
                # duplicates from the loss sums/normalizers exactly
                batch['sample_valid'] = valid_rows
            return batch

        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # never block forever in q.put: an abandoned iteration (the
            # next(iter(loader)) init fetch, max_batches-capped evals) sets
            # `stop` but can't drain the queue — a bare put would park this
            # thread for the process lifetime holding prefetch+1 batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # exceptions must reach the consumer — a dead producer would
            # otherwise leave the training loop blocked on q.get() forever
            try:
                for bi in batches:
                    if stop.is_set():
                        return
                    if not put_or_stop(load_batch(bi)):
                        return
                put_or_stop(None)
            except BaseException as e:  # noqa: BLE001
                put_or_stop(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()

        def gen():
            try:
                while True:
                    item = q.get()
                    if item is None:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                stop.set()

        return gen()
