"""A cell at the port's tiny CPU-test geometry, for the harness's CPU tests:
the same harness, judge and reference as a chip run, at a size a test run
holds."""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness import configfile  # noqa: E402

# the tests run in several workers at once: a few threads each
torch.set_num_threads(2)
from benchmark.harness.cell import Run  # noqa: E402
from benchmark.harness.main import load_json  # noqa: E402


def tiny_spec(loop: str, use_cam: bool, limits_of: str):
    """A tiny camera (or LiDAR) cell held to the real cell ``limits_of``'s
    limits."""
    from mm_training_tpu_torch.configs import tiny_test_config
    cfg = tiny_test_config(use_cam=use_cam, batch_size=2, max_points_per_frame=2048)
    traffic = load_json(ROOT / 'benchmark' / 'traffic' / f'{loop}_b4.json')
    traffic.update(batch_size=2, pool=2, points_per_frame=2048, boxes_per_frame=[2, 8],
                   checked_calls=2, warmup_calls=1)
    return {'workload': limits_of, 'config': {'config': configfile.to_dict(cfg)},
            'traffic': traffic,
            'limits': load_json(ROOT / 'benchmark' / 'limits' / f'{limits_of}.json')}


def run_tiny(loop: str, use_cam: bool, limits_of: str, seed: int = 2 ** 33 + 7,
             limits=None, **kw):
    spec = tiny_spec(loop, use_cam, limits_of)
    if limits is not None:
        spec['limits'] = limits
    return Run(spec, seed, 0.5, False, 'cpu', time.perf_counter(), **kw).run()
