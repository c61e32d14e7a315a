"""The quotient kernel's share of its roofline, in %: the least time (the
bytes of arith.quotient_bytes, computed from the cell's layout, at
arith.PEAK_BYTES_PER_S), summed over the traced requests, each at its
entry's claim, over the kernel's device time in them."""

import re

from arith import PEAK_BYTES_PER_S, quotient_bytes

KERNEL = re.compile(r"\bquotients_kernel\b")


def read(run):
    td = run.traced
    traced = [r for r in run.requests if r.traced]
    if td is None or not traced:
        return None
    s = sum(v for k, v in td.kernel_s.items() if KERNEL.search(k))
    if s <= 0:
        return None
    claims = run.cell.claims
    least = sum(quotient_bytes(claims[r.entry], run.cell.config) for r in traced) / PEAK_BYTES_PER_S
    return 100.0 * least / s
