"""The request generator: one general reader of the traffic files in
``benchmark/traffic/``.

A traffic file lists, under `requests`, the programs of its mix. Each
entry has a `name`, a Brainfuck program (its source, inline), the bytes it
reads, a prelude and a `weight`. The prelude is `cells` tape cells from
cell `gap` on, past every cell the program uses, that it fills from the
input and prints before it walks back to cell 0 and the program starts.
Request i of a run with seed s reads prelude bytes drawn from (s, i), so
consecutive requests carry different data while every request of an entry
executes the same instructions the same number of times: an entry's table
sizes are its own whatever the seed.

Which entry request i is: the requests of a run go in blocks, each holding
every entry `weight` times, in an order drawn from the seed and the block's
index. So every seed gives the same set of requests, in another order.

A run is one closed-loop client: each request is sent when the one before
has its proof.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def _rng(*words: int) -> np.random.Generator:
    return np.random.default_rng([w % (1 << 64) for w in words])


@dataclass(frozen=True)
class Entry:
    """One program of a mix."""
    name: str
    program: str          # Brainfuck source
    program_input: bytes  # the bytes the program itself reads
    gap: int              # cells between the program's cells and the prelude's
    cells: int            # prelude cells, each read from the input and printed
    weight: int = 1       # requests of this entry in each block

    @staticmethod
    def from_json(spec: dict) -> "Entry":
        return Entry(spec["name"], spec["program"], bytes(spec["input"]),
                     int(spec["prelude"]["gap"]), int(spec["prelude"]["cells"]),
                     int(spec.get("weight", 1)))

    @property
    def source(self) -> str:
        """The request's whole source: the prelude, then the program."""
        k = self.gap + self.cells
        return ">" * self.gap + ",.>" * self.cells + "<" * k + self.program


@dataclass(frozen=True)
class Traffic:
    name: str
    entries: Tuple[Entry, ...]

    @staticmethod
    def from_json(name: str, spec: dict) -> "Traffic":
        entries = tuple(Entry.from_json(e) for e in spec["requests"])
        if not entries or len({e.name for e in entries}) != len(entries) or any(
                e.weight < 1 for e in entries):
            raise ValueError(f"traffic {name}: entries need distinct names and weights >= 1")
        return Traffic(name, entries)

    def entry(self, seed: int, index: int) -> Entry:
        """The entry of request `index` of a run with `seed`."""
        block = [e for e in self.entries for _ in range(e.weight)]
        if len(block) == 1:
            return block[0]
        b, pos = divmod(index, len(block))
        return block[int(_rng(seed, b, 0xB10C).permutation(len(block))[pos])]

    def request(self, seed: int, index: int, entry: Optional[Entry] = None) -> Tuple[str, bytes]:
        """(source, input bytes) of request `index` of a run with `seed`, of
        `entry` where given (the set-up's warm-ups, at negative indices)."""
        e = entry or self.entry(seed, index)
        prelude = _rng(seed, index).integers(0, 256, e.cells, dtype=np.uint8).tobytes()
        return e.source, prelude + e.program_input
