"""The bytes one card moves at least in a prove's mesh stages, from the
cell's layout (the claim, the configuration and the number of cards W),
frozen here so that the count is the same whatever implements the stages.

On W cards every array of at least 2W rows is row-sharded, a chunk of 1/W
of its rows a card. Each such circle-FFT transform has log2 W cross stages;
in each, every word of a card's chunk is read once and written once and
the partner card's word is read once: 12 bytes a position of the chunk.
The composition's per-size sum reads two chunks and writes one: 12 bytes a
position too. The transforms of a prove:

- each committed tree's extend (trees 1-3: the main and interaction traces
  and the composition's four columns), a size at a time: an interpolate at
  the trace size and an evaluate at the blown-up size, every column of
  that size;
- the composition's combination: an interpolate of four columns at each
  component size's blown-up size, one sum for each size past the first,
  and one evaluate of four columns at the composition size.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

from reference.verify import PcsConfig, layout

BYTES_A_POSITION = 12


def _stages(log_size: int, columns: int, split: int) -> int:
    """Bytes of one transform's cross stages on one card: none where the
    array stays whole (fewer than 2 rows a card)."""
    if log_size < split + 1:
        return 0
    return BYTES_A_POSITION * columns * (1 << (log_size - split)) * split


def cross_bytes(claim: Dict[str, int], config: dict, world: int) -> int:
    """Least bytes one card moves in one prove's cross stages and sums."""
    split = world.bit_length() - 1
    if world < 2:
        return 0
    cfg = PcsConfig(**config)
    blow = cfg.log_blowup
    _comps, trees = layout(claim, cfg)
    total = 0
    for metas in trees[1:]:
        for log_size, columns in Counter(m.log_size for m in metas).items():
            total += _stages(log_size, columns, split) + _stages(log_size + blow, columns, split)
    comp_log = trees[3][0].log_size
    sizes = sorted({n + blow for n in claim.values()})
    total += sum(_stages(lg, 4, split) for lg in sizes) + _stages(comp_log, 4, split)
    if comp_log >= split + 1:
        total += BYTES_A_POSITION * 4 * (1 << (comp_log - split)) * (len(sizes) - 1)
    return total
