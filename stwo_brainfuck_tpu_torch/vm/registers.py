"""Trace row: the 7 registers recorded per clock cycle
(reference: crates/brainfuck_vm/src/registers.rs:5-27)."""

from __future__ import annotations

from dataclasses import dataclass

# Column order used across every trace array in the framework.
TRACE_COLUMNS = ("clk", "ip", "ci", "ni", "mp", "mv", "mvi")


@dataclass
class Registers:
    clk: int = 0
    ip: int = 0
    ci: int = 0
    ni: int = 0
    mp: int = 0
    mv: int = 0
    mvi: int = 0

    def as_tuple(self):
        return (self.clk, self.ip, self.ci, self.ni, self.mp, self.mv, self.mvi)
