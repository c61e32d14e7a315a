"""The benchmark's own arithmetic on traces and layouts, frozen here so
that it reads the same work whatever implements it.

- `busy_union`: the device's busy time as the union of its kernel and copy
  intervals, and the idle gaps between them (the arithmetic of the port's
  chip_smoke.py phase_split, copied).
- `quotient_bytes`: the bytes the quotient step has to move at least: each
  opened column's blown-up evaluation read once (4 B a value) and one QM31
  (16 B) written a point of each FRI input size.
- `PEAK_BYTES_PER_S`: one H100 SXM's HBM3 bandwidth, NVIDIA's data sheet.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from reference.verify import PcsConfig, layout

PEAK_BYTES_PER_S = 3.35e12


def busy_union(spans: Sequence[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(busy time, idle gaps) of (start, end) intervals."""
    busy, end, gaps = 0.0, None, []
    for a, b in sorted(spans):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, gaps


def quotient_bytes(claim: Dict[str, int], config: dict) -> int:
    """Least bytes of one prove's quotient step, from the cell's layout."""
    cfg = PcsConfig(**config)
    _comps, trees = layout(claim, cfg)
    reads, sizes = 0, set()
    for metas in trees:
        for meta in metas:
            if meta.shifts:
                size = meta.log_size + cfg.log_blowup
                reads += 4 << size
                sizes.add(size)
    return reads + sum(16 << s for s in sizes)
