"""Training runtime: epoch loop, checkpoints, early stopping, eval, export.

The port of ``mm_training_tpu/training/trainer.py``, on one card or as one
rank of a data-parallel group, which re-designs the reference's Lightning
wiring (exps/mm_training_aim.py: BEVDepthLightningModel + create_trainer):
  * fit: epoch loop over the train step, sanity val steps, per-epoch
    validation, top-k checkpoints by val_detection_loss + a 'latest'
    checkpoint every N steps (mm_training_aim.py:590-604), early stopping
    (patience 8 on val_detection_loss, :597), config snapshot (:582-583),
    resume from 'latest' with the loop state, K-step groups
    (``steps_per_dispatch``) with the single-step tail, ``max_steps``.
  * validate/test: decode on the card, BEV mAP on the host via
    MAPCalculator (:291-342,416-422), aiMotive-format JSON export mirroring
    the dataset tree (:514-519), PR curves; the first batch of each eval
    pass logged as panels (BEV raster, heatmaps, depth, camera 0, the 3D
    scene), and the same panels of the train batch every
    ``viz_every_n_steps`` (:637-726); a renderer failure warns once and
    does not stop the run.
  * predict: decode and export the aiMotive JSONs of a split, batch i's
    export overlapping batch i+1's step (:728-746); with ``use_ema`` and
    ``use_tta`` eval and predict run on the EMA shadow and the flip
    ensemble (``training/train_step.py``); ``fold_bn_for_inference`` folds
    the weights for deploy (``models/bn_fold.py``); ``profile`` traces a
    few train steps with ``torch.profiler`` (:578-608).
  * checkpoints: the JAX package's layout, ``saved_models/{best,latest}/
    <step>/``, with one ``torch.save`` file a step (``state.pt``: the step,
    the model's float32 masters and BN statistics, the optimizer's moments
    and count, the EMA shadow under ``use_ema``, the loop state) and the
    step's metrics (``metrics.json``).
    A step is written into a temporary directory and renamed into place, so
    a killed run never leaves half a step; with ``async_checkpointing`` a
    thread writes a host copy. A port checkpoint does not load in the JAX
    package, nor the other way round; the reference's torch checkpoints
    do, through ``scripts/import_checkpoint.py``.

Host-to-device copies (``_device_batches``): batch i+1 is copied into
pinned memory and to the card with ``non_blocking=True`` on a side stream
while step i runs; the step's stream waits on the copy's event, and the
tensors are marked as used by it.

Data and model parallelism (``parallel/``, a process group formed before
the trainer is made, e.g. under ``torchrun``; the trainer lays the ranks out
by ``model_parallel`` and ``num_slices``, ``parallel.make_mesh``): each data
rank loads its rows of every global batch of ``batch_size`` x data-parallel
size samples (its model peers the same rows), starts from rank 0's weights
and runs the steps, whose statistics, normalizers and gradients are the
global batch's (``training/train_step.py``); the learning rate follows the
global batch. Rank 0 alone logs and writes ``config.json`` and the
checkpoints (every rank waits for each write and reads it on restore); the
ranks of model index 0 export the JSONs of their own rows; eval pools the
data ranks' mAP accumulations on rank 0 and weights each batch's global
losses by its global count of valid samples, so every rank sees the same
val loss and stops at the same epoch.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import traceback
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .. import parallel, resolve_device
from ..configs import CLASSES, Config, raw_rig
from ..core.geometry import rig_is_row_independent
from ..core.transforms import yaw_to_quat
from ..data.aimotive_dataset import AiMotiveDataset
from ..evaluation import MAPCalculator
from ..models import BEVDepthLiDAR
from ..models.bn_fold import fold_state
from ..models.torch_import import (convert_torchvision_resnet, load_reference_state_dict,
                                   merge_state_dict)
from ..utils.logging import MetricsLogger, NullLogger
from ..utils.profiling import StepTimer, profile_trace
from ..utils.renderer import (draw_boxes_camera, draw_points_camera, render_bev,
                              render_depth_panel, render_heatmap_panel)
from .loader import PrefetchLoader, stack_batches
from .train_step import (HOST_FIELDS, TrainState, create_train_state, make_eval_step,
                         make_state_predict_step, make_train_step, make_train_step_multi)

__all__ = ['Trainer', 'boxes_to_aimotive_dict', 'initial_loop_state']

CKPT_FILE = 'state.pt'
METRICS_FILE = 'metrics.json'
BEST_METRIC = 'val_detection_loss'


def boxes_to_aimotive_dict(boxes: np.ndarray, scores: np.ndarray,
                           labels: np.ndarray, class_names=CLASSES) -> dict:
    """Decoded boxes (bottom-z) -> aiMotive CapturedObjects JSON
    (pred_dict_to_aimotive_dict, mm_training_aim.py:218-250: origin z =
    bottom z + dz/2)."""
    out = {'CapturedObjects': []}
    for box, score, label in zip(boxes, scores, labels):
        quat = yaw_to_quat(float(box[6]))
        out['CapturedObjects'].append({
            'BoundingBox3D Origin X': float(box[0]),
            'BoundingBox3D Origin Y': float(box[1]),
            'BoundingBox3D Origin Z': float(box[2]) + float(box[5]) / 2,
            'BoundingBox3D Extent X': float(box[3]),
            'BoundingBox3D Extent Y': float(box[4]),
            'BoundingBox3D Extent Z': float(box[5]),
            # dataset schema keys (annotation.py) — the reference's exporter
            # writes 'BoundingBox3D Relative Velocity *' instead, which its
            # own loader cannot parse back; deviation makes exports
            # round-trip as annotations
            'Relative Velocity X': float(box[7]),
            'Relative Velocity Y': float(box[8]),
            'Relative Velocity Z': 0,
            'BoundingBox3D Orientation Quat X': float(quat[0]),
            'BoundingBox3D Orientation Quat Y': float(quat[1]),
            'BoundingBox3D Orientation Quat Z': float(quat[2]),
            'BoundingBox3D Orientation Quat W': float(quat[3]),
            'ObjectType': class_names[int(label)],
            'Score': float(score),
        })
    return out


def initial_loop_state() -> dict:
    """The loop state of a run that has not started (what a checkpoint
    carries besides the weights)."""
    return {'epoch': 0, 'batch_in_epoch': 0, 'best_val': float('inf'), 'patience': 0}


class Trainer:
    """Fit, validate and test one model on one device (default the card;
    ``device='cpu'`` runs the kernels' plain versions), alone or as this
    process's rank of the process group, laid out by the config's
    ``model_parallel`` and ``num_slices`` (``self.mesh``; a world the two do
    not divide raises, naming them)."""

    def __init__(self, cfg: Config, data_root: Optional[str] = None,
                 datasets: Optional[Dict[str, object]] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = parallel.make_mesh(cfg.model_parallel, cfg.num_slices)
        self.data_root = data_root or cfg.data_root
        self.map_calculator = MAPCalculator()
        self.state: Optional[TrainState] = None
        self._datasets = datasets or {}
        self._loaders: Dict[str, PrefetchLoader] = {}
        self.out_path = Path(cfg.output_path)
        self.logger = (MetricsLogger(self.out_path, cfg.experiment_name,
                                     log_every=cfg.log_every_n_steps)
                       if parallel.is_main_process() else NullLogger())
        self._ckpt_writes: Dict[str, threading.Thread] = {}
        self._ckpt_errors: list = []
        self.global_step = 0
        # training-loop state (checkpointed with the weights — Lightning
        # restores Trainer + callback state on ckpt_path resume,
        # mm_training_aim.py:597,638: EarlyStopping counters, epoch, loader
        # position). _loop_restored flips when a checkpoint carried it.
        self.loop_state = initial_loop_state()
        self._loop_restored = False
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == 'cuda'
                             else None)

    # ----------------------------------------------------------------- data
    def dataset(self, split: str) -> AiMotiveDataset:
        if split not in self._datasets:
            self._datasets[split] = AiMotiveDataset(self.data_root, self.cfg,
                                                    split=split)
        return self._datasets[split]

    @property
    def data_parallel_size(self) -> int:
        """Ranks on the data axis (JAX :121-123)."""
        return self.mesh.data_parallel

    def loader(self, split: str) -> PrefetchLoader:
        """Host loader of this rank's ``cfg.batch_size`` rows of each global
        batch of ``cfg.batch_size`` x :attr:`data_parallel_size` samples
        (JAX :125-146), by its data index. Eval loaders pad the trailing
        global batch (n_valid marker) so no frame is dropped from the
        metric."""
        if split not in self._loaders:
            train = split == 'train'
            global_bs = self.cfg.batch_size * self.data_parallel_size
            self._loaders[split] = PrefetchLoader(
                self.dataset(split), global_bs,
                shuffle=train, num_workers=self.cfg.num_workers,
                seed=self.cfg.seed, drop_last=train, pad_last=not train,
                process_rows=parallel.process_batch_bounds(global_bs),
                worker_mode=self.cfg.loader_worker_mode)
        return self._loaders[split]

    def close(self):
        """Wait for checkpoint writes, release the loaders' workers and the
        logger's files (idempotent)."""
        self.wait_for_checkpoints()
        for ld in self._loaders.values():
            ld.close()
        self.logger.close()

    # ---------------------------------------------------------------- setup
    def setup(self, steps_per_epoch: Optional[int] = None):
        """Fix the LR schedule's ``steps_per_epoch`` (default: the train
        loader's length in global batches), build the steps and write
        ``config.json`` (rank 0)."""
        if steps_per_epoch is None:
            try:
                steps_per_epoch = max(1, len(self.loader('train')))
            except TypeError:
                # a custom injected dataset without __len__ — the ONLY case
                # where a default is meaningful. Loud: the LR milestones
                # are scheduled in steps.
                import warnings
                steps_per_epoch = 1000
                warnings.warn(
                    'train dataset has no __len__; defaulting '
                    f'steps_per_epoch={steps_per_epoch} — LR epoch '
                    'milestones will be scheduled against this value. Pass '
                    'Trainer.setup(steps_per_epoch=...) explicitly.',
                    stacklevel=2)
        self.steps_per_epoch = steps_per_epoch
        self._build_steps()
        self.out_path.mkdir(parents=True, exist_ok=True)
        if parallel.is_main_process():
            with open(self.out_path / 'config.json', 'w') as f:
                json.dump(dataclasses.asdict(self.cfg), f, indent=2, default=str)

    def _build_steps(self):
        cfg = self.cfg
        self._train_step = make_train_step(cfg)
        self._train_step_multi = (make_train_step_multi(cfg, cfg.steps_per_dispatch)
                                  if cfg.steps_per_dispatch > 1 else None)
        self._eval_step = make_eval_step(cfg)
        self._predict_step = make_state_predict_step(cfg)

    def init_state(self, sample_batch: Dict[str, np.ndarray]):
        """Build the model (seeded from ``cfg.seed``) and its optimizer;
        then restore ``cfg.ckpt_path`` when set (a trainer checkpoint, or
        one ``scripts/import_checkpoint.py`` wrote from a reference
        checkpoint). A camera rig with roll, pitch or skew switches the
        model to the general splat first (``configs.raw_rig``), as the JAX
        trainer does. With the camera and
        ``ImageBackboneConf.pretrained``, that torchvision-format file is
        merged into the image backbone after the optimizer and the EMA
        shadow are made, as JAX :209-224 does: the shadow starts from the
        random init. In a process group every rank starts from rank 0's
        parameters and floating buffers (one broadcast a bucket), and the
        learning rate is scaled by the data-parallel size."""
        if not hasattr(self, '_train_step'):
            raise RuntimeError('call setup() before init_state()')
        cfg = self.cfg
        if (cfg.use_cam and cfg.get_backbone_conf().factorized_splat
                and not rig_is_row_independent(sample_batch['sensor2ego'],
                                               sample_batch['intrin'])):
            import warnings
            warnings.warn('camera rig has roll/pitch or intrinsic skew — switching to the '
                          'general (non-factorized) splat for exact geometry', stacklevel=2)
            self.cfg = raw_rig(cfg)
            self._build_steps()      # the splat is parameter-free: the same state
        model = BEVDepthLiDAR(self.cfg, device=self.device)
        parallel.broadcast_buckets([t for t in model.state_dict().values()
                                    if t.is_floating_point()])
        self.state = create_train_state(self.cfg, model, self.steps_per_epoch)
        pretrained = (self.cfg.use_cam and
                      self.cfg.get_backbone_conf().img_backbone_conf.pretrained)
        if pretrained:
            prefix = 'backbone.img_backbone.'
            merge_state_dict(model, convert_torchvision_resnet(
                load_reference_state_dict(pretrained), prefix), strict_prefix=prefix)
        if self.cfg.ckpt_path:
            self.restore(self.cfg.ckpt_path)
        return self.state

    def fold_bn_for_inference(self):
        """Fold this trainer's conv+BN pairs for inference, in place
        (``models/bn_fold.py``; the EMA shadow too), and rebuild the steps.
        The fold is the model's own: another Trainer in the process keeps
        its BatchNorms. Inference-only: a train step on the folded model
        raises ValueError. Call after init_state/restore."""
        if self.state is None:
            raise RuntimeError('fold_bn_for_inference requires an initialized state '
                               '(call init_state first)')
        self.state = fold_state(self.state)
        self._build_steps()

    # ----------------------------------------------------------- checkpoint
    def save_checkpoint(self, name='best', metrics: Optional[dict] = None):
        """Write the state under ``saved_models/<name>/<step>/``: 'best'
        keeps the ``save_top_k`` steps of least val_detection_loss,
        'latest' the newest step only. With ``async_checkpointing`` a thread
        writes a host copy of the state; a new save of ``name`` first waits
        for the previous one. In a process group rank 0 writes, at once, and
        every rank waits for the write before it goes on."""
        if self.state is None:
            return
        root = self.out_path / 'saved_models' / name
        step = int(self.state.step)
        keep = self.cfg.save_top_k if name == 'best' else 1
        if parallel.process_count() > 1:
            if parallel.is_main_process():
                _write_checkpoint(root, step, _state_to_dict(self.state, self.loop_state),
                                  metrics, keep, name == 'best')
            parallel.barrier()
            return
        self._join_write(name)
        snapshot = _state_to_dict(self.state, self.loop_state)   # host copy
        args = (root, step, snapshot, metrics, keep, name == 'best')
        if not self.cfg.async_checkpointing:
            _write_checkpoint(*args)
            return

        def write():
            try:
                _write_checkpoint(*args)
            except BaseException as e:  # noqa: BLE001 - re-raised by _join_write
                self._ckpt_errors.append(e)
        t = threading.Thread(target=write, name=f'checkpoint-{name}', daemon=False)
        t.start()
        self._ckpt_writes[name] = t

    def _join_write(self, name: str):
        t = self._ckpt_writes.pop(name, None)
        if t is not None:
            t.join()
        if self._ckpt_errors:
            err = self._ckpt_errors.pop(0)
            self._ckpt_errors.clear()
            raise RuntimeError('a checkpoint write failed') from err

    def wait_for_checkpoints(self):
        """Wait for every checkpoint write in flight (no-op when sync or
        idle); re-raises a failed write. Called on fit() exit and before
        restore(), so a write is never read half-finished or lost to the
        process's exit."""
        for name in list(self._ckpt_writes):
            self._join_write(name)

    def restore(self, path: str):
        """Restore the weights, optimizer, step and loop state from a
        checkpoint root (``saved_models/best``: its best step by
        val_detection_loss; ``latest``: its newest) or one step directory.
        Raises on a missing or empty path — silently training from scratch
        is the exact failure checkpointing exists to prevent."""
        if self.state is None:
            raise RuntimeError('call init_state first')
        self.wait_for_checkpoints()
        path = os.path.abspath(path)
        if not os.path.isdir(path):
            raise FileNotFoundError(f'checkpoint path {path!r} is not a directory')
        step_dirs = [d for d in os.listdir(path) if d.isdigit()]
        if step_dirs:
            path = os.path.join(path, str(_pick_restore_step(path, step_dirs)))
        file = os.path.join(path, CKPT_FILE)
        if not os.path.isfile(file):
            raise FileNotFoundError(f'no checkpoint ({CKPT_FILE}) under {path!r}')
        tree = torch.load(file, map_location='cpu', weights_only=True)
        _load_state(self.state, tree)
        self.global_step = int(self.state.step)
        self.loop_state = dict(tree['loop'])
        self._loop_restored = True
        return self.state

    # ------------------------------------------------------------------ fit
    def fit(self, max_epochs: Optional[int] = None,
            max_steps: Optional[int] = None, resume: bool = True):
        """Train. With ``resume`` (default), a 'latest' checkpoint already in
        out_path is restored first — preemption recovery: the periodic
        latest-checkpoint (latest_every_n_steps) plus this makes a killed run
        continue where it stopped."""
        try:
            return self._fit(max_epochs, max_steps, resume)
        finally:
            # the last 'latest'/'best' write may still be in flight — never
            # leave fit (or unwind an exception) with it unfinished
            self.wait_for_checkpoints()

    def _fit(self, max_epochs, max_steps, resume):
        cfg = self.cfg
        max_epochs = max_epochs if max_epochs is not None else cfg.max_epochs
        train_loader = self.loader('train')
        if self.state is None:
            if not hasattr(self, '_train_step'):
                self.setup()
            try:
                first = next(iter(train_loader))
            except StopIteration:
                raise ValueError(
                    f'train split has {len(self.dataset("train"))} frames — fewer than one '
                    f'batch of {cfg.batch_size}; drop_last leaves the loader empty') from None
            self.init_state(first)
            latest = self.out_path / 'saved_models' / 'latest'
            if resume and not cfg.ckpt_path and latest.is_dir():
                self.restore(str(latest))

        # sanity val steps (num_sanity_val_steps=2, mm_training_aim.py:624)
        if cfg.num_sanity_val_steps:
            self._run_eval('val', max_batches=cfg.num_sanity_val_steps, log=False)

        kdisp = max(1, cfg.steps_per_dispatch)
        timer = StepTimer()
        # resume: the checkpointed loop state carries the exact epoch,
        # loader position and early-stop counters (Lightning parity —
        # callbacks + loaders restore on ckpt_path resume,
        # mm_training_aim.py:597,638)
        if self._loop_restored:
            start_epoch = self.loop_state['epoch']
            resume_batch = self.loop_state['batch_in_epoch']
        else:
            start_epoch = self.global_step // max(1, self.steps_per_epoch)
            resume_batch = 0
        for epoch in range(start_epoch, max_epochs):
            train_loader.set_epoch(epoch)
            if resume_batch:
                # mid-epoch resume: fast-forward the deterministic batch
                # plan (saves at step boundaries keep this a multiple of
                # the K group size, so grouping stays aligned with the
                # unkilled run's)
                train_loader.skip_batches(resume_batch)
            self.loop_state['epoch'] = epoch
            self.loop_state['batch_in_epoch'] = resume_batch
            resume_batch = 0
            for batch, device_batch, stacked in self._device_batches(train_loader,
                                                                     stack=kdisp):
                if max_steps and self.global_step >= max_steps:
                    # a resume at or past max_steps runs nothing
                    break
                timer.start()
                prev_step = self.global_step
                remaining = max_steps - self.global_step if max_steps else None
                if stacked and remaining is not None and remaining < kdisp:
                    # the final group would overshoot max_steps: run only the
                    # remaining batches through the single step, so training
                    # lands EXACTLY on max_steps
                    for k in range(remaining):
                        self.state, metrics = self._train_step(
                            self.state, {key: v[k] for key, v in device_batch.items()})
                    n = remaining * batch['points'].shape[1]
                elif stacked:
                    self.state, metrics = self._train_step_multi(self.state, device_batch)
                    n = batch['points'].shape[0] * batch['points'].shape[1]
                else:
                    # batches that do not fill a K group run one by one
                    # (no sample is dropped)
                    self.state, metrics = self._train_step(self.state, device_batch)
                    n = batch['points'].shape[0]
                float(metrics['train_loss'])      # the step's end: the timer's barrier
                self.global_step = int(self.state.step)
                self.loop_state['batch_in_epoch'] += kdisp if stacked else 1
                timer.stop(n_samples=n)
                self.logger.log_step(self.global_step, metrics)
                if cfg.viz_every_n_steps and (
                        self.global_step // cfg.viz_every_n_steps
                        > prev_step // cfg.viz_every_n_steps):
                    self._log_train_viz(batch, device_batch, kdisp if stacked else 1)
                if cfg.latest_every_n_steps and (
                        self.global_step // cfg.latest_every_n_steps
                        > prev_step // cfg.latest_every_n_steps):
                    self.save_checkpoint('latest')
                if max_steps and self.global_step >= max_steps:
                    break
            for k, v in timer.summary().items():
                self.logger.log_scalar(self.global_step, k, v)

            val_metrics = self._run_eval('val')
            vloss = val_metrics.get('val_detection_loss', float('inf'))
            # update the early-stop counters BEFORE the epoch-end save so a
            # resume from this checkpoint makes the same stop/best decisions
            # as the unkilled run
            if vloss < self.loop_state['best_val']:
                self.loop_state['best_val'] = vloss
                self.loop_state['patience'] = 0
            else:
                self.loop_state['patience'] += 1
            self.loop_state['epoch'] = epoch + 1
            self.loop_state['batch_in_epoch'] = 0
            self.save_checkpoint('best', metrics={BEST_METRIC: vloss})
            if self.loop_state['patience'] >= cfg.early_stop_patience:
                break
            if max_steps and self.global_step >= max_steps:
                break
        return self.state

    # ----------------------------------------------------------------- eval
    def _run_eval(self, split: str, prefix: Optional[str] = None,
                  max_batches: Optional[int] = None, log: bool = True,
                  export: bool = False) -> Dict[str, float]:
        cfg = self.cfg
        prefix = prefix or split
        loader = self.loader(split)
        self.map_calculator.reset()
        agg: Dict[str, float] = {}
        count = 0

        def consume(bi, batch, metrics, out, viz):
            nonlocal count
            metrics = {k: float(v) for k, v in metrics.items()}
            boxes, scores, labels, valid = (t.cpu().numpy() for t in out)
            self._accumulate_map(batch, boxes, scores, labels, valid)
            if log and bi == 0 and parallel.is_main_process():
                self._log_scene_panel(batch, boxes, scores, labels, valid, prefix, viz)
            if export:
                self._export_results(batch, boxes, scores, labels, valid)
            # weight by valid samples so a padded trailing batch (pad_last)
            # contributes proportionally, not as a full batch; the global
            # count (JAX :522-530): the losses are the global batch's
            w = int(batch.get('n_valid_global', boxes.shape[0]))
            for k, v in metrics.items():
                agg[k] = agg.get(k, 0.0) + v * w
            count += w

        # batch i+1's eval step is enqueued before batch i's outputs are read
        # back, so the host's read and mAP accumulation of batch i overlap
        # the card's work on batch i+1
        pending = None
        for bi, (batch, device_batch, _) in enumerate(self._device_batches(loader,
                                                                           max_batches)):
            metrics, out, viz = self._eval_step(self.state, device_batch)
            if pending is not None:
                consume(*pending)
            pending = (bi, batch, metrics, out, viz)
        if pending is not None:
            consume(*pending)
        out = {f'{prefix}_{k}': v / max(count, 1) for k, v in agg.items()}
        if parallel.process_count() > 1:
            # pool the data ranks' accumulations on rank 0 (JAX :552-560);
            # model peers hold the same rows, and rank 0 is model index 0
            pooled = [(self.map_calculator.gts, self.map_calculator.preds,
                       self.map_calculator.img_names)]
            if self.data_parallel_size > 1:
                pooled = parallel.all_gather_object(pooled[0], group=parallel.data_group())
            self.map_calculator.reset()
            if parallel.is_main_process():
                for gts, preds, names in pooled:
                    self.map_calculator.update(gts, preds, names)
        if count and len(self.map_calculator):
            bev = self.map_calculator.compute_bev(iou_thr=0.3, x_range=cfg.point_cloud_range[3])
            out.update({f'{prefix}_{k}': float(v) for k, v in bev.items()})
            if export:
                # PR curves + per-class AP per eval (utils/eval.py:483-499)
                self.map_calculator.export_pr_curves(
                    str(self.out_path / 'metrics' / prefix), iou_thr=0.3,
                    x_range=cfg.point_cloud_range[3], class_names=CLASSES)
        self.map_calculator.reset()
        if log:
            self.logger.log_eval(self.global_step, out)
        return out

    def profile(self, n_steps: int = 5) -> str:
        """Trace ``n_steps`` train steps (wrapping around the train loader)
        with ``torch.profiler`` into ``out_path/profile/trace.json`` (a
        Chrome trace; the card's kernels on a CUDA device) and return that
        directory. Each step's loss is read on the host, so the trace holds
        the steps' device work."""
        loader = self.loader('train')
        if not hasattr(self, '_train_step'):
            self.setup()  # same guard as fit(): a fresh Trainer can profile
        if self.state is None:
            self.init_state(next(iter(loader)))

        def batches():
            while True:
                empty = True
                for item in self._device_batches(loader):
                    empty = False
                    yield item
                if empty:
                    raise ValueError('the train loader yields no batch to profile')

        out = self.out_path / 'profile'
        it = batches()
        with profile_trace(str(out), cuda=self.device.type == 'cuda'):
            for _ in range(n_steps):
                _, device_batch, _ = next(it)
                self.state, metrics = self._train_step(self.state, device_batch)
                float(metrics['train_loss'])
        it.close()
        self.global_step = int(self.state.step)
        return str(out)

    def predict(self, split='val', max_batches=None):
        """Decode ``split`` with the state's eval weights (the EMA shadow
        under ``use_ema``; the flip ensemble under ``use_tta``) and write one
        aiMotive JSON a frame under ``out_path/outputs``. Batch i is
        exported while batch i+1's predict step runs on the card."""
        if self.state is None:
            raise RuntimeError('call init_state first')
        pending = None
        for batch, device_batch, _ in self._device_batches(self.loader(split), max_batches):
            out = self._predict_step(self.state, device_batch)
            if pending is not None:
                self._export_results(pending[0], *(t.cpu().numpy() for t in pending[1]))
            pending = (batch, out)
        if pending is not None:
            self._export_results(pending[0], *(t.cpu().numpy() for t in pending[1]))

    def validate(self, max_batches=None):
        return self._run_eval('val', max_batches=max_batches)

    def test(self, max_batches=None):
        return self._run_eval('val', prefix='test', max_batches=max_batches, export=True)

    def test_all_odds(self, odds=('highway', 'urban', 'night', 'rain'),
                      max_batches=None) -> Dict[str, Dict[str, float]]:
        """Per-ODD evaluation (the reference runs one config file per ODD,
        exps/configs/eval_*.py; here it is one call)."""
        out = {}
        for odd in odds:
            try:
                ds = AiMotiveDataset(self.data_root, self.cfg, split='val', eval_odd=odd)
            except FileNotFoundError:
                continue
            if not len(ds):
                continue
            key = f'val_{odd}'
            self._datasets[key] = ds
            old = self._loaders.pop(key, None)
            if old is not None:
                old.close()
            out[odd] = self._run_eval(key, prefix=f'test_{odd}', max_batches=max_batches)
        return out

    # ----------------------------------------------------------------- viz
    def _log_train_viz(self, batch, device_batch, kdisp: int):
        """Decode the current train batch with the eval step and log its
        panels (reference: wandb Object3D/log_images every 200 train steps,
        mm_training_aim.py:270-284). Not in a process group of more than one
        rank (JAX :641-644): the eval batches' panels remain."""
        if parallel.process_count() > 1:
            return
        try:
            if kdisp > 1:  # stacked [K, B, ...]: take the last batch
                batch = {k: (v[-1] if isinstance(v, np.ndarray) else v)
                         for k, v in batch.items()}
                device_batch = {k: v[-1] for k, v in device_batch.items()}
            _, out, viz = self._eval_step(self.state, device_batch)
            self._log_scene_panel(batch, *(t.cpu().numpy() for t in out), 'train', viz)
        except Exception as e:  # noqa: BLE001 - viz must never break training
            self._warn_viz_failure(e)

    def _log_scene_panel(self, batch, boxes, scores, labels, valid, prefix, viz=None):
        """First-batch panels: BEV raster (GT white, predictions
        class-colored), per-task heatmaps, expected-depth map, and camera 0
        with projected points and box wireframes, plus the 3D scene — the
        reference's wandb Object3D / log_images artifacts
        (mm_training_aim.py:379-404,491-499)."""
        try:
            v = np.asarray(valid[0]) & (np.asarray(scores[0]) > 0.3)
            pts0 = np.asarray(batch['points'][0])[np.asarray(batch['point_mask'][0])]
            gt0 = np.asarray(batch['gt_boxes'][0])[np.asarray(batch['gt_mask'][0])]
            pred_b = np.asarray(boxes[0])[v]
            pred_l = np.asarray(labels[0])[v]
            if len(pred_b):
                # decode returns bottom-center z (mmdet3d parity); every viz
                # helper (box_corners_3d, log_scene_3d) and the GT use
                # gravity-center z — shift once here
                pred_b = pred_b.copy()
                pred_b[:, 2] += pred_b[:, 5] / 2.0
            img = render_bev(pts0, gt_boxes=gt0, pred_boxes=pred_b, pred_labels=pred_l,
                             pc_range=self.cfg.point_cloud_range, px_per_m=2.0)
            self.logger.log_image(self.global_step, f'{prefix}_bev', img)
            self.logger.log_scene_3d(self.global_step, f'{prefix}_scene', pts0,
                                     gt_boxes=gt0, pred_boxes=pred_b, pred_labels=pred_l)
            if viz is not None and 'heatmaps' in viz:
                hm = viz['heatmaps'].float().cpu().numpy()
                self.logger.log_image(self.global_step, f'{prefix}_heatmaps',
                                      render_heatmap_panel(list(hm)))
            if viz is not None and 'depth' in viz:
                self.logger.log_image(
                    self.global_step, f'{prefix}_depth',
                    render_depth_panel(viz['depth'].float().cpu().numpy(),
                                       self.cfg.get_backbone_conf().d_bound))
            if self.cfg.use_cam and 'imgs' in batch:
                cam_img = np.asarray(batch['imgs'][0, 0, 0])[..., :3]
                cam_img = np.ascontiguousarray(cam_img, np.uint8)
                extr = np.asarray(batch['extrinsics'][0]).reshape(-1, 4, 4)[0]
                intr = np.asarray(batch['intrin'][0]).reshape(-1, 4, 4)[0]
                cam_img = draw_points_camera(cam_img, pts0, extr, intr)
                cam_img = draw_boxes_camera(cam_img, gt0, extr, intr, color=(255, 255, 255))
                cam_img = draw_boxes_camera(cam_img, pred_b, extr, intr, labels=pred_l)
                self.logger.log_image(self.global_step, f'{prefix}_cam0', cam_img)
        except Exception as e:  # noqa: BLE001 - viz must never break eval
            self._warn_viz_failure(e)

    def _warn_viz_failure(self, exc: Exception):
        """Viz panels are best-effort, but a renderer regression should not
        ship as silently-missing images: surface the first failure."""
        if not getattr(self, '_viz_warned', False):
            self._viz_warned = True
            warnings.warn('visualization panel failed (suppressed for the rest of the run): '
                          + ''.join(traceback.format_exception_only(exc)).strip())

    # -------------------------------------------------------------- helpers
    def _to_device(self, batch):
        """(the batch's arrays on the device, the copy's event, the pinned
        host tensors); on the CPU (the arrays, None, None).

        On the card each array is copied into pinned memory, then to the
        card with ``non_blocking=True`` on the side stream; the event marks
        the copies' end. The caller keeps the pinned tensors until its step
        is done."""
        arrays = {k: v for k, v in batch.items() if k not in HOST_FIELDS}
        if self._copy_stream is None:
            return arrays, None, None
        pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in arrays.items()}
        with torch.cuda.stream(self._copy_stream):
            dev = {k: t.to(self.device, non_blocking=True) for k, t in pinned.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return dev, event, pinned

    def _device_batches(self, loader, max_batches: Optional[int] = None, stack: int = 1):
        """Yield (host_batch, device_batch, stacked) with the NEXT batch's
        copy already enqueued, so it overlaps the current step.

        With ``stack`` > 1, groups that many loader batches on a leading K
        axis for the K-step group. An incomplete trailing group is NOT
        dropped: its batches are yielded one by one with stacked=False and
        the caller runs them through the single step."""
        it = iter(loader)
        if stack > 1:
            def grouped(src):
                group = []
                for b in src:
                    group.append(b)
                    if len(group) == stack:
                        yield True, stack_batches(group)
                        group = []
                for b in group:
                    yield False, b
            it = grouped(it)
        else:
            it = ((False, b) for b in it)

        stream = (torch.cuda.current_stream(self.device) if self._copy_stream is not None
                  else None)

        def ready(item):
            host, (dev, event, _pinned), stacked = item
            if event is not None:
                stream.wait_event(event)
                for t in dev.values():
                    t.record_stream(stream)      # made on the copy stream, used on this one
            return host, dev, stacked

        cur = None
        count = 0
        for stacked, nxt in it:
            nxt_item = (nxt, self._to_device(nxt), stacked)
            if cur is not None:
                yield ready(cur)
                count += 1
                if max_batches is not None and count >= max_batches:
                    return
            cur = nxt_item
        if cur is not None and (max_batches is None or count < max_batches):
            yield ready(cur)

    def _accumulate_map(self, batch, boxes, scores, labels, valid):
        gts, preds = [], []
        for i in range(batch.get('n_valid', boxes.shape[0])):
            v = valid[i]
            # decode emits bottom z; GT carries center z. BEV metrics ignore
            # z, keep as-is (parity with result_list, mm_training_aim.py:315)
            preds.append([boxes[i][v].copy(), scores[i][v], labels[i][v]])
            gm = batch['gt_mask'][i]
            gts.append([batch['gt_boxes'][i][gm], batch['gt_labels'][i][gm]])
        self.map_calculator.update(gts, preds, batch.get('path'))

    def _export_results(self, batch, boxes, scores, labels, valid):
        if parallel.model_index():      # model index 0 writes its rows' files
            return
        save_dir = self.out_path / 'outputs'
        paths = batch.get('path', [])
        paths = paths[:batch.get('n_valid', len(paths))]
        for i, path in enumerate(paths):
            v = valid[i]
            d = boxes_to_aimotive_dict(boxes[i][v], scores[i][v], labels[i][v])
            # relpath, not str.replace: replace() fires on EVERY occurrence
            # of data_root in the path and silently leaves the path
            # unchanged on a normalization mismatch — which would overwrite
            # the dataset's ground-truth annotation JSON in place
            rel = os.path.relpath(os.path.abspath(path), os.path.abspath(str(self.data_root)))
            if rel.startswith('..'):
                rel = os.path.basename(path)  # outside data_root: flat name
            out_file = Path(save_dir) / rel
            out_file.parent.mkdir(parents=True, exist_ok=True)
            with open(out_file, 'w') as f:
                json.dump(d, f)


def _pick_restore_step(root: str, step_dirs) -> int:
    """The step to restore from a directory of step checkpoints: the step
    of least val_detection_loss among those that recorded it (a 'best' root
    keeps the top save_top_k steps, and the newest kept step is not the
    best one), else the newest step ('latest', a root without metrics)."""
    scored = []
    for d in step_dirs:
        file = os.path.join(root, d, METRICS_FILE)
        if os.path.isfile(file):
            with open(file) as f:
                metrics = json.load(f)
            if BEST_METRIC in metrics:
                scored.append((metrics[BEST_METRIC], -int(d)))
    if scored:
        return -min(scored)[1]
    return max(int(d) for d in step_dirs)


def _state_to_dict(state: TrainState, loop_state: dict) -> dict:
    """A host copy of what a checkpoint holds."""
    def host(t):
        return t.detach().to('cpu', copy=True)
    opt = state.optimizer
    tree = {'step': int(state.step),
            'model': {k: host(v) for k, v in state.model.state_dict().items()},
            'optimizer': {'mu': [host(t) for t in opt.mu], 'nu': [host(t) for t in opt.nu],
                          'count': int(opt.count)},
            'loop': dict(loop_state)}
    if state.ema is not None:
        tree['ema'] = {k: host(v) for k, v in state.ema.items()}
    return tree


@torch.no_grad()
def _load_state(state: TrainState, tree: dict) -> None:
    """Load a checkpoint's tree into ``state``, its EMA shadow too when the
    state has one (``use_ema``), which the checkpoint must then hold."""
    state.model.load_state_dict(tree['model'])
    if state.ema is not None:
        if 'ema' not in tree:
            raise KeyError('the checkpoint holds no EMA shadow (it was written without '
                           'use_ema): restore it with use_ema=False')
        for k, t in state.ema.items():
            t.copy_(tree['ema'][k])
    opt = state.optimizer
    for dst, src in zip(opt.mu + opt.nu, tree['optimizer']['mu'] + tree['optimizer']['nu']):
        dst.copy_(src)
    opt.count = int(tree['optimizer']['count'])
    state.step = int(tree['step'])


def _write_checkpoint(root: Path, step: int, tree: dict, metrics: Optional[dict],
                      keep: int, by_metric: bool) -> None:
    """Write ``tree`` (and ``metrics``) as ``root/<step>/`` through a
    temporary directory renamed into place, then prune ``root`` to ``keep``
    steps: the least val_detection_loss ones when ``by_metric``, else the
    newest."""
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f'.tmp-{step}-{os.getpid()}-{threading.get_ident()}'
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save(tree, tmp / CKPT_FILE)
    with open(tmp / METRICS_FILE, 'w') as f:
        json.dump(metrics or {}, f)
    final = root / str(step)
    if final.exists():          # the same step saved again: replace it
        old = root / f'.old-{step}-{os.getpid()}-{threading.get_ident()}'
        os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old)
    else:
        os.replace(tmp, final)
    steps = [d for d in os.listdir(root) if d.isdigit()]
    if by_metric:
        def key(d):
            with open(root / d / METRICS_FILE) as f:
                return (json.load(f).get(BEST_METRIC, float('inf')), -int(d))
        ranked = sorted(steps, key=key)
    else:
        ranked = sorted(steps, key=int, reverse=True)
    for d in ranked[keep:]:
        shutil.rmtree(root / d)
