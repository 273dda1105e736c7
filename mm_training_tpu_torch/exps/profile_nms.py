"""Kernel K3 (circle NMS) by kind of row and row length, on the card.

Times one call of :func:`~mm_training_tpu_torch.ops.circle_nms.circle_nms_mask`
(device time, calls queued back to back) on 4 rows with the ``lidar_radar``
head's per-task thresholds, passed by value as the decode passes them. The
kinds of row, each unsorted:

- ``uniform``: centres uniform over the point-cloud range, 90% valid (the
  rows of ``chip_smoke.py``'s K3 row), at K from 1 to 1024;
- ``objects``: 500 candidates around 24 objects (1 m spread), 90% valid,
  as a trained head's top-500 gathers around the frame's objects;
- ``identical``: 500 equal centres (one box kept a row);
- ``chain``: 500 centres on a line, each within the threshold of its
  neighbours only, scores falling along it: every other box is kept and
  every diagonal block resolves 16 kept boxes in turn, the sweep's most
  sequential case;
- ``decode``: the rows that the decode of a full-width ``lidar_radar`` B=1
  request passes (seeded random weights).

Prints one JSON object: the card, and for each row kind and K the device
ms of a call and the boxes kept.

    python -m mm_training_tpu_torch.exps.profile_nms
"""
from __future__ import annotations

import json
import subprocess
from unittest import mock

import torch

from ..configs import lidar_radar
from ..data import make_fake_batch
from ..models import BEVDepthLiDAR
from ..ops import build, circle_nms
from ..training import make_predict_step
from .timing import device_ms

__all__ = ['main', 'nms_rows']

UNIFORM_K = (1, 31, 64, 128, 256, 500, 1024)


def nms_rows(kind: str, k: int, pc, thresh, gen):
    """(centers [R, K, 2], scores [R, K], valid [R, K]) of one kind, R the
    number of thresholds, on the generator's device."""
    dev = gen.device
    r = len(thresh)
    lo = torch.tensor(pc[:2], device=dev)
    hi = torch.tensor(pc[3:5], device=dev)
    scores = torch.rand(r, k, generator=gen, device=dev)
    valid = torch.rand(r, k, generator=gen, device=dev) < 0.9
    if kind == 'uniform':
        centers = lo + torch.rand(r, k, 2, generator=gen, device=dev) * (hi - lo)
    elif kind == 'objects':
        objs = lo + torch.rand(r, 24, 2, generator=gen, device=dev) * (hi - lo)
        centers = (objs[:, torch.arange(k, device=dev) % 24]
                   + torch.randn(r, k, 2, generator=gen, device=dev))
    elif kind == 'identical':
        centers = torch.zeros(r, k, 2, device=dev)
    elif kind == 'chain':
        step = 0.9 * torch.tensor(thresh, device=dev).sqrt()      # step^2 <= th < (2 step)^2
        line = torch.arange(k, device=dev, dtype=torch.float32)
        perm = torch.randperm(k, generator=gen, device=dev)
        centers = torch.stack([line[perm] * step[:, None], torch.zeros(r, k, device=dev)], -1)
        scores = 1 - line[perm] / k * torch.ones(r, 1, device=dev)
        valid = torch.ones(r, k, dtype=torch.bool, device=dev)
    else:
        raise ValueError(kind)
    return centers.contiguous(), scores, valid


def _decode_rows(cfg):
    """The (centers, scores, valid) that one B=1 predict request's decode
    passes to K3."""
    model = BEVDepthLiDAR(cfg, device='cuda', generator=torch.Generator().manual_seed(0))
    predict = make_predict_step(cfg, model)
    seen = []
    launch = circle_nms.circle_nms_mask

    def record(centers, scores, valid, thresh):
        seen.append((centers.clone(), scores.clone(), valid.clone()))
        return launch(centers, scores, valid, thresh)
    record.launches = 0   # the wrapped function counts its launches here while patched
    with mock.patch.object(circle_nms, 'circle_nms_mask', record):
        predict(make_fake_batch(cfg, batch_size=1, seed=0))
    return seen[-1]


def main() -> dict:
    build.build_kernels(('circle_nms', 'affine_act', 'voxelize'))   # the decode's path, at once
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()
    cfg = lidar_radar(batch_size=1, max_points_per_frame=100_000)
    head = cfg.get_head_conf()
    thresh = tuple(float(v) for v in head.test_cfg.min_radius[:len(head.tasks)])
    gen = torch.Generator(device='cuda').manual_seed(0)
    cases = [('uniform', k, nms_rows('uniform', k, cfg.point_cloud_range, thresh, gen))
             for k in UNIFORM_K]
    cases += [(kind, 500, nms_rows(kind, 500, cfg.point_cloud_range, thresh, gen))
              for kind in ('objects', 'identical', 'chain')]
    decode = _decode_rows(cfg)
    cases.append(('decode', decode[0].shape[1], decode))
    rows = []
    for kind, k, (centers, scores, valid) in cases:
        def call():
            return circle_nms.circle_nms_mask(centers, scores, valid, thresh)
        keep = call()
        if not torch.equal(keep, circle_nms.circle_nms_mask_plain(centers, scores, valid, thresh)):
            raise AssertionError(f'K3 differs from its plain version on {kind} rows, K={k}')
        rows.append(dict(kind=kind, k=k, ms=device_ms(call, 200), kept=int(keep.sum()),
                         valid=int(valid.sum())))
    result = dict(card=card, thresholds=thresh, rows=rows)
    print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
