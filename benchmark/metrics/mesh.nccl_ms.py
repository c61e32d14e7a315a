"""Rank 0's device time in NCCL's kernels (`ncclDevKernel_*`, `ncclKernel_*`:
the collectives, and their waits for the peers, which the card counts as
busy; not the profiler's `nccl:<op>` annotations laid over them) a traced
request, from the profiler, in ms."""

import re

KERNELS = re.compile(r"^nccl(Dev)?Kernel")


def read(run):
    td = run.traced
    if td is None or not td.requests:
        return None
    s = sum(v for k, v in td.kernel_s.items() if KERNELS.match(k))
    return 1e3 * s / td.requests if s > 0 else None
