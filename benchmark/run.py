"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, and with --trace 1 breakdown; the numbers compared
come last under checks); the numbers compared are also the last lines of
standard error. Exits non-zero, printing no result, without the CUDA
devices the cell asks for, or if the process holds JAX or the JAX package
once the window has closed.
"""

import time

_STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402


def _process_start() -> float:
    """The process's start on the perf_counter clock (from /proc where it
    can be read, else this module's first line)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _STARTED


if __name__ == "__main__":
    started = min(_process_start(), _STARTED)
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    # caches of anything that compiles stay inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(root, ".bench_cache", sub)
    # one host thread for the CPU libraries: the prover's host work is Python and numpy on
    # one thread, and idle pool threads would only contend with it for the host's cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ.setdefault("USE_FLAX", "0")
    # the process on a fixed set of the host's cores, the last four it may use: the
    # scheduler then keeps the prover's threads there instead of moving them mid-window
    # (the ranks of a cell on several cards share out the cores it may use)
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-4:])
    sys.path[:0] = [here, root]
    from harness import main

    sys.exit(main(sys.argv[1:], started, cores))
