"""One-command accuracy-parity runbook against the released checkpoints.

The port's ``mm_training_tpu/exps/parity.py``. The reference ships four
checkpoints (LiDAR, LiDAR+camera, LiDAR+radar, LiDAR+radar+camera) whose
per-ODD BEV mAP (``MAPCalculator.compute_bev``, AP at IoU 0.3, x up to
204.8 m; the reference's exps/mm_training_aim.py:416-422) is the accuracy
target of the aiMotive paper (arXiv:2211.09445). With the data and the
checkpoints on disk:

    python -m mm_training_tpu_torch.exps.parity \\
        --data-root /path/to/aimotive_dataset \\
        --ckpt-dir  /path/to/released_checkpoints \\
        [--out parity_out] [--paper-json paper_numbers.json] \\
        [--variants lidar_only lidar_cam ...] [--max-batches N] [--device cpu]

For every variant it finds the checkpoint in ``--ckpt-dir`` by its file
name (:func:`find_checkpoint`), converts it (``scripts/import_checkpoint.py``
with the sparse-import LiDAR encoder: zero skipped weights), evaluates it per
ODD (highway, urban, night, rain: the reference's exps/configs/eval_*.py
matrix) through ``Trainer.test_all_odds`` and on the whole val split, and
writes ``parity_report.md`` (ours against the paper, a row per variant and
ODD) and ``parity_report.json``. ``--paper-json`` holds {"<variant>":
{"<odd>": mAP}}; a cell without a number renders as a dash.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback
from pathlib import Path

__all__ = ['ODDS', 'VARIANTS', 'find_checkpoint', 'main', 'run_parity']

VARIANTS = ('lidar_only', 'lidar_radar', 'lidar_cam', 'lidar_cam_radar')
ODDS = ('highway', 'urban', 'night', 'rain')

# file-name stems accepted per variant (the released files are downloaded by
# hand: match generously but unambiguously)
_CKPT_STEMS = {
    'lidar_only': ('lidar_only', 'lidar'),
    'lidar_radar': ('lidar_radar', 'lidar+radar'),
    'lidar_cam': ('lidar_cam', 'lidar_camera', 'lidar+cam'),
    'lidar_cam_radar': ('lidar_cam_radar', 'lidar_camera_radar', 'lidar+radar+cam',
                        'lidar_radar_cam'),
}


def _classify_stem(stem: str):
    """The variant of a checkpoint's file-name stem: the LONGEST matching
    stem wins, so 'lidar_cam_radar-v3' never lands on lidar_only."""
    stem = stem.lower()
    best, best_len = None, 0
    for v, stems in _CKPT_STEMS.items():
        for s in stems:
            if ((stem == s or stem.startswith((s + '_', s + '-', s + '.')))
                    and len(s) > best_len):
                best, best_len = v, len(s)
    return best


def find_checkpoint(ckpt_dir: str, variant: str):
    """The first checkpoint file (.ckpt, .pth, .pt; sorted by name) in
    ``ckpt_dir`` whose stem names ``variant``, or None."""
    files = sorted(p for p in Path(ckpt_dir).iterdir() if p.suffix in ('.ckpt', '.pth', '.pt'))
    mine = [p for p in files if _classify_stem(p.stem) == variant]
    return str(mine[0]) if mine else None


def _eval_variant(variant, ckpt, data_root, out_dir: Path, odds, max_batches=None,
                  eval_split='val', cfg_factory=None, device=None):
    """Convert one checkpoint and evaluate it per ODD and on the split."""
    from ..configs import variants as variant_factories
    from ..scripts.import_checkpoint import import_checkpoint
    from ..training.trainer import Trainer

    factory = cfg_factory or (lambda v, **kw: getattr(variant_factories, v)(**kw))
    cfg = factory(variant, data_root=data_root, out_path=str(out_dir / variant),
                  num_sanity_val_steps=0)
    if cfg.use_lidar:   # the exact spconv import: zero skipped weights
        cfg = cfg.replace(lidar_conf=dataclasses.replace(cfg.get_lidar_conf(),
                                                         variant='sparse_import'))
    converted = out_dir / 'converted' / variant
    report = import_checkpoint(ckpt, cfg, out=str(converted), smoke=False, device=device)
    cfg = cfg.replace(ckpt_path=str(converted))
    trainer = Trainer(cfg, device=device)
    try:
        trainer.setup(steps_per_epoch=1)
        trainer.init_state(next(iter(trainer.loader(eval_split))))   # restores ckpt_path
        per_odd = trainer.test_all_odds(odds=odds, max_batches=max_batches)
        overall = trainer.validate(max_batches=max_batches)
    finally:
        trainer.close()
    return {'import_report': report,
            'overall': {k: float(v) for k, v in overall.items()},
            'per_odd': {o: {k: float(v) for k, v in m.items()} for o, m in per_odd.items()}}


def _fmt_table(results: dict, paper: dict, odds) -> str:
    """Markdown: one row per (variant, ODD), ours against the paper."""
    lines = ['| model | ODD | mAP (ours) | mAP (paper 2211.09445) | delta |',
             '|---|---|---|---|---|']
    for variant, res in results.items():
        if 'error' in res:
            lines.append(f'| {variant} | — | FAILED: {res["error"]} | | |')
            continue
        for odd in odds:
            m = res['per_odd'].get(odd)
            ours = m.get(f'test_{odd}_ap_auc') if m else None
            ref = (paper.get(variant) or {}).get(odd)
            delta = f'{ours - ref:+.3f}' if ours is not None and ref is not None else ''
            ours_s = f'{ours:.3f}' if ours is not None else '—'
            ref_s = f'{ref:.3f}' if ref is not None else '—'
            lines.append(f'| {variant} | {odd} | {ours_s} | {ref_s} | {delta} |')
        ov = res['overall'].get('val_ap_auc')
        lines.append(f'| {variant} | all ({len(res["per_odd"])} ODDs) | '
                     + (f'{ov:.3f}' if ov is not None else '—') + ' | — | |')
    return '\n'.join(lines)


def run_parity(data_root: str, ckpt_dir: str, out: str = 'parity_out', variants=VARIANTS,
               odds=ODDS, paper_json=None, max_batches=None, cfg_factory=None,
               device=None) -> dict:
    """Run the runbook; ``cfg_factory(variant, **kw) -> Config`` replaces the
    production variant factories (the tests run the same pipeline on the
    tiny geometry). A variant without a checkpoint, or whose conversion or
    eval raises, is reported as such and the others still run."""
    out_dir = Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)
    paper = {}
    if paper_json:
        with open(paper_json) as f:
            paper = json.load(f)
    results = {}
    for variant in variants:
        ckpt = find_checkpoint(ckpt_dir, variant)
        if ckpt is None:
            results[variant] = {'error': f'no checkpoint for {variant} found in {ckpt_dir}'}
            print(f'[parity] {variant}: SKIPPED — {results[variant]["error"]}')
            continue
        print(f'[parity] {variant}: converting {os.path.basename(ckpt)} and evaluating '
              'per ODD...')
        try:
            results[variant] = _eval_variant(variant, ckpt, data_root, out_dir, odds,
                                             max_batches, cfg_factory=cfg_factory,
                                             device=device)
        except Exception as e:  # noqa: BLE001 - one broken checkpoint must not end the sweep
            traceback.print_exc()
            results[variant] = {'error': f'{type(e).__name__}: {e}'}
    table = _fmt_table(results, paper, odds)
    report = {'data_root': data_root, 'ckpt_dir': ckpt_dir, 'results': results}
    with open(out_dir / 'parity_report.json', 'w') as f:
        json.dump(report, f, indent=2, default=str)
    (out_dir / 'parity_report.md').write_text(
        '# Accuracy parity against the released reference checkpoints\n\n'
        'Metric: BEV mAP (AP at IoU 0.3 AUC, axis-aligned BEV, x <= 204.8 m), '
        'MAPCalculator.compute_bev, the reference\'s exps/mm_training_aim.py:416-422 '
        'protocol.\n\n' + table + '\n')
    print(table)
    print(f'[parity] full report: {out_dir / "parity_report.json"}')
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--data-root', required=True)
    p.add_argument('--ckpt-dir', required=True,
                   help='directory with the released reference checkpoints')
    p.add_argument('--out', default='parity_out')
    p.add_argument('--variants', nargs='+', default=list(VARIANTS), choices=list(VARIANTS))
    p.add_argument('--odds', nargs='+', default=list(ODDS))
    p.add_argument('--paper-json', default=None,
                   help='JSON {"variant": {"odd": mAP}} with the paper table')
    p.add_argument('--max-batches', type=int, default=None, help='cap eval batches')
    p.add_argument('--device', default=None,
                   help='torch device (default cuda; cpu runs the plain versions)')
    args = p.parse_args(argv)
    return run_parity(args.data_root, args.ckpt_dir, out=args.out,
                      variants=tuple(args.variants), odds=tuple(args.odds),
                      paper_json=args.paper_json, max_batches=args.max_batches,
                      device=args.device)


if __name__ == '__main__':
    main()
