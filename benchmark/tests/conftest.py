"""The benchmark's own tests: run with `python -m pytest benchmark/tests -q`
from the root of the repository (the CPU); tests marked `gpu` run on a
card and skip without one."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
