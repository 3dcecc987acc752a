"""Put the benchmark's folder and the repository root on ``sys.path``."""

import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for _p in (str(ROOT), str(BENCH_DIR)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
