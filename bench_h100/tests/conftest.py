"""The benchmark's own tests: ``python -m pytest bench_h100/tests`` from the
checkout's root.  They import the harness by its folder, as ``run.py`` does."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)
