"""The AIR's framework on the host: lookup elements, the constraint
evaluator at one out-of-domain point, and the component base class.

A frozen copy of the host mode of the port's framework/component.py (its
device mode is left out): a component's define_constraints, run on sampled
QM31 values at the OODS point, gives its constraint values there.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

from . import field as F
from .field import P_INT


@dataclass(frozen=True)
class LookupElements:
    """Combine values as sum_i alpha^i * v_i - z."""

    z: tuple
    alpha: tuple
    size: int

    @staticmethod
    def draw(channel, size: int) -> "LookupElements":
        z = channel.draw_felt()
        alpha = channel.draw_felt()
        return LookupElements(z=z, alpha=alpha, size=size)

    @property
    def alpha_powers(self) -> List[tuple]:
        powers = [F.ONE]
        for _ in range(self.size - 1):
            powers.append(F.h_mul(powers[-1], self.alpha))
        return powers

    def combine(self, values: Sequence) -> tuple:
        acc = F.ZERO
        for a, v in zip(self.alpha_powers, values):
            vq = (v % P_INT, 0, 0, 0) if isinstance(v, int) else v
            acc = F.h_add(acc, F.h_mul(a, vq))
        return F.h_sub(acc, self.z)


class Expr:
    """A QM31 value (host tuple) that reads algebraically in the
    component definitions; integer constants lift to QM31."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    @staticmethod
    def _lift(other) -> "Expr":
        if isinstance(other, Expr):
            return other
        if isinstance(other, int):
            return Expr((other % P_INT, 0, 0, 0))
        raise TypeError(type(other))

    def __add__(self, other):
        return Expr(F.h_add(self.v, self._lift(other).v))

    def __sub__(self, other):
        return Expr(F.h_sub(self.v, self._lift(other).v))

    def __rsub__(self, other):
        return self._lift(other).__sub__(self)

    def __mul__(self, other):
        return Expr(F.h_mul(self.v, self._lift(other).v))

    __radd__ = __add__
    __rmul__ = __mul__


@dataclass
class RelationEntry:
    elements_name: str
    numerator: Expr
    values: List[Expr]


class Evaluator:
    """Collects a component's constraint values at one point: main columns
    and the is_first column as sampled QM31 values, interaction columns as
    recombined QM31 values."""

    def __init__(self, component, main, interaction, interaction_prev_sum,
                 is_first, claimed_sum, elements):
        self.component = component
        self._main = main
        self._interaction = interaction
        self._prev_sum = interaction_prev_sum
        self._is_first = is_first
        self._claimed_sum = claimed_sum
        self._elements = elements
        self.constraints: List[Expr] = []
        self.relations: List[RelationEntry] = []

    def col(self, name: str) -> Expr:
        return Expr(self._main[name])

    def is_first(self) -> Expr:
        return Expr(self._is_first)

    def add(self, expr: Expr) -> None:
        self.constraints.append(expr)

    def relation(self, elements_name: str, numerator: Expr, values: List[Expr]) -> None:
        self.relations.append(RelationEntry(elements_name, numerator, values))

    def finalize_logup(self) -> None:
        """The LogUp constraints: per entry k, Q_k * den_k - num_k = 0; the
        prefix sum, S - S_prev - sum(Q_k) + is_first * claimed_sum = 0."""
        n = len(self.relations)
        if len(self._interaction) != n + 1:
            raise ValueError(f"{len(self._interaction)} interaction columns for {n} relations")
        q_sum = None
        for k, rel in enumerate(self.relations):
            els = self._elements[rel.elements_name]
            den = Expr(els.combine([v.v for v in rel.values]))
            q_k = Expr(self._interaction[k])
            self.add(q_k * den - rel.numerator)
            q_sum = q_k if q_sum is None else q_sum + q_k
        s = Expr(self._interaction[n])
        self.add(s - Expr(self._prev_sum) - q_sum + self.is_first() * Expr(self._claimed_sum))


class _CountingEvaluator(Evaluator):
    def finalize_logup(self) -> None:  # tolerates missing interaction columns
        pass


class Component:
    """Base class of the AIR components."""

    name: str = "component"
    columns: Tuple[str, ...] = ()

    def __init__(self, log_size: int):
        self.log_size = log_size

    def define_constraints(self, e: Evaluator) -> None:
        raise NotImplementedError

    def relation_count(self) -> int:
        return _counts(type(self))[0]

    def constraint_count(self) -> int:
        return _counts(type(self))[1]

    def constraints_at(self, main: Dict[str, tuple], interaction: List[tuple], prev_sum: tuple,
                       is_first: tuple, claimed_sum: tuple, elements) -> List[tuple]:
        e = Evaluator(self, main, interaction, prev_sum, is_first, claimed_sum, elements)
        self.define_constraints(e)
        return [c.v for c in e.constraints]


@lru_cache(maxsize=None)
def _counts(cls) -> Tuple[int, int]:
    """(relations, constraints) of a component class, by one dry run."""
    comp = cls(0)
    dummy = {k: LookupElements((7, 1, 0, 0), (3, 0, 0, 0), n)
             for k, n in (("memory", 3), ("instruction", 3), ("processor", 7))}
    probe = _CountingEvaluator(comp, {c: F.ZERO for c in comp.columns}, [], F.ZERO, F.ZERO,
                               F.ZERO, dummy)
    comp.define_constraints(probe)
    n_rel = len(probe.relations)
    values = comp.constraints_at({c: F.ZERO for c in comp.columns}, [F.ZERO] * (n_rel + 1),
                                 F.ZERO, F.ZERO, F.ZERO, dummy)
    return n_rel, len(values)
