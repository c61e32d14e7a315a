"""Device time of the Blake2s kernels (csrc/blake2s.cu: the tree, level,
grind and chain kernels) a traced request, from the profiler, in ms."""

import re

KERNELS = re.compile(r"\b(tree_kernel|level_kernel|grind_kernel|chain_kernel)\b")


def read(run):
    td = run.traced
    if td is None or not td.requests:
        return None
    s = sum(v for k, v in td.kernel_s.items() if KERNELS.search(k))
    return 1e3 * s / td.requests if s > 0 else None
