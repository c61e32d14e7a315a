"""The mesh-stage kernel's share of its roofline, in %: the least time (the
bytes of arith_mesh.cross_bytes, counted from the cell's layout and its
number of cards, at arith.PEAK_BYTES_PER_S), summed over the traced
requests, each at its entry's claim, over rank 0's device time in the
kernel in them. None where the program has no such kernel."""

import re

from arith import PEAK_BYTES_PER_S
from arith_mesh import cross_bytes

KERNEL = re.compile(r"\bmesh_cross_kernel\b")


def read(run):
    td = run.traced
    traced = [r for r in run.requests if r.traced]
    if td is None or not traced:
        return None
    s = sum(v for k, v in td.kernel_s.items() if KERNEL.search(k))
    if s <= 0:
        return None
    cell = run.cell
    least = sum(cross_bytes(cell.claims[r.entry], cell.config, cell.chips)
                for r in traced) / PEAK_BYTES_PER_S
    return 100.0 * least / s
