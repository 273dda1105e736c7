"""Run one cell of the benchmark on this machine's card(s):

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object; the numbers compared end standard error."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's and the benchmark's caches, at fixed paths inside the checkout
for var, sub in (('TRITON_CACHE_DIR', 'triton'), ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
    os.environ[var] = str(ROOT / 'benchmark' / '_cache' / sub)
sys.path.insert(0, str(ROOT))

from benchmark.harness.main import main  # noqa: E402

if __name__ == '__main__':
    sys.exit(main(t_start=T_START))
