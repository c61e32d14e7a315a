"""Constraint framework: components, constraint evaluation, LogUp.

Counterpart of ``stwo_brainfuck_tpu/framework/component.py`` (its
per-member form; the JAX package's union-group executables only cut its
compile count and are numerically identical).

- Main-trace columns use the "flattened next row" layout, so no mask
  offsets are needed on main columns.
- LogUp layout: for each relation entry k the prover commits a QM31 fraction
  column Q_k = num_k / den_k (constraint: Q_k * den_k - num_k = 0), plus ONE
  QM31 prefix-sum column S per component with the cyclic constraint
      S(p) - S(p - g) - sum_k Q_k(p) + is_first(p) * claimed_sum = 0.
- The only mask offset is S at -1: on the prover side a precomputed index
  permutation of the blown-up evaluation, on the verifier side one extra
  sample point z - g.

A component subclass defines `columns` and `define_constraints(e)` with the
evaluator API; the same definition drives the prover's tensor evaluation,
the verifier's point evaluation, the interaction trace and the counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core import m31, qm31
from ..core.fft import coset_order_permutation
from ..core.m31 import P_INT


# ---------------------------------------------------------------------------
# Lookup elements (drawn from the channel): z and alpha powers
# ---------------------------------------------------------------------------

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

    @staticmethod
    def dummy(size: int) -> "LookupElements":
        # z has a nonzero imaginary coordinate so that combine() of
        # M31-valued rows with real alpha powers can never hit zero.
        return LookupElements(z=(7, 1, 0, 0), alpha=(3, 0, 0, 0), size=size)

    @property
    def alpha_powers(self) -> List[tuple]:
        powers = [qm31.ONE]
        for _ in range(self.size - 1):
            powers.append(qm31.h_mul(powers[-1], self.alpha))
        return powers

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        """Device form: alpha_powers (K, 4) and z (4,) int64 tensors."""
        return {
            "alpha_powers": torch.tensor(self.alpha_powers, dtype=torch.int64, device=device),
            "z": torch.tensor(self.z, dtype=torch.int64, device=device),
        }

    def combine_host(self, values: Sequence) -> tuple:
        acc = qm31.ZERO
        for a, v in zip(self.alpha_powers, values):
            vq = (v % P_INT, 0, 0, 0) if isinstance(v, int) else v
            acc = qm31.h_add(acc, qm31.h_mul(a, vq))
        return qm31.h_sub(acc, self.z)


# ---------------------------------------------------------------------------
# Expression values: device tensors (M31 (N,) or QM31 (4, N)) or host tuples
# ---------------------------------------------------------------------------

class Expr:
    """Wrapper so constraint definitions read algebraically.

    Host mode wraps QM31 tuples. Device mode tracks the field kind: main
    trace columns stay M31 tensors (N,) and promote to QM31 (4, N) only when
    combined with extension-field values. Integer constants stay Python
    ints until combined with a tensor."""

    __slots__ = ("v", "host", "qm")

    def __init__(self, v, host: bool, qm: bool = True):
        self.v = v
        self.host = host
        self.qm = qm

    def _lift(self, other) -> "Expr":
        if isinstance(other, Expr):
            return other
        if isinstance(other, int):
            if self.host:
                return Expr((other % P_INT, 0, 0, 0), True)
            return Expr(other % P_INT, False, qm=False)
        raise TypeError(type(other))

    def _qm(self, like) -> torch.Tensor:
        """This value as a QM31 tensor; `like` (a tensor) gives the device
        for a constant."""
        if self.qm:
            return self.v
        if isinstance(self.v, int):
            return qm31.const((self.v, 0, 0, 0), like.device)
        return qm31.from_m31(self.v)

    def _binary(self, o: "Expr", m31_op, qm31_op, host_op) -> "Expr":
        if self.host:
            return Expr(host_op(self.v, o.v), True)
        if self.qm or o.qm:
            like = self.v if isinstance(self.v, torch.Tensor) else o.v
            return Expr(qm31_op(self._qm(like), o._qm(like)), False, True)
        v = m31_op(self.v, o.v)
        if isinstance(v, int):
            v %= P_INT
        return Expr(v, False, False)

    def __add__(self, other):
        return self._binary(self._lift(other), m31.add, qm31.add, qm31.h_add)

    def __sub__(self, other):
        return self._binary(self._lift(other), m31.sub, qm31.sub, qm31.h_sub)

    def __rsub__(self, other):
        return self._lift(other).__sub__(self)

    def __mul__(self, other):
        return self._binary(self._lift(other), m31.mul, qm31.mul, qm31.h_mul)

    __radd__ = __add__
    __rmul__ = __mul__


# ---------------------------------------------------------------------------
# Relation entries and component base
# ---------------------------------------------------------------------------

@dataclass
class RelationEntry:
    elements_name: str      # "memory" / "instruction" / "processor"
    numerator: "Expr"       # signed multiplicity (e.g. d - 1, 1 - d, -1)
    values: List["Expr"]    # combined values


class Evaluator:
    """Collects constraints while a component's define_constraints runs.

    Modes:
    - device: columns are M31 tensors on the (blown-up) evaluation domain;
      interaction columns are QM31 tensors; results are QM31 tensors.
    - host (point): columns are sampled QM31 values at the OODS point.
    """

    def __init__(self, component, main, interaction, interaction_prev_sum,
                 is_first, claimed_sum, elements, host: bool):
        self.component = component
        self._main = main
        self._interaction = interaction
        self._prev_sum = interaction_prev_sum
        self._is_first = is_first
        self._claimed_sum = claimed_sum
        self._elements = elements
        self.host = host
        self.constraints: List[Expr] = []
        self.relations: List[RelationEntry] = []

    # -- component API -----------------------------------------------------

    def col(self, name: str) -> Expr:
        v = self._main[name]
        return Expr(v, True) if self.host else Expr(v, False, qm=False)

    def is_first(self) -> Expr:
        v = self._is_first
        return Expr(v, True) if self.host else Expr(v, False, qm=False)

    def add(self, expr: Expr) -> None:
        self.constraints.append(expr)

    def relation(self, elements_name: str, numerator: Expr, values: List[Expr]) -> None:
        self.relations.append(RelationEntry(elements_name, numerator, values))

    # -- framework: turn relations into interaction constraints -------------

    def finalize_logup(self) -> None:
        """Append the LogUp constraints:
        per entry k: Q_k * den_k - num_k = 0;
        cumsum: S - S_prev - sum(Q_k) + is_first * claimed_sum = 0."""
        n = len(self.relations)
        if len(self._interaction) != n + 1:
            raise ValueError(f"{len(self._interaction)} interaction columns for {n} relations")
        q_sum: Optional[Expr] = None
        for k, rel in enumerate(self.relations):
            els = self._elements[rel.elements_name]
            if self.host:
                den = Expr(els.combine_host([v.v for v in rel.values]), True)
            else:
                den = Expr(_device_combine(els, [v.v for v in rel.values]), False)
            q_k = Expr(self._interaction[k], self.host)
            self.add(q_k * den - rel.numerator)
            q_sum = q_k if q_sum is None else q_sum + q_k
        s = Expr(self._interaction[n], self.host)
        s_prev = Expr(self._prev_sum, self.host)
        claimed = Expr(self._claimed_sum, self.host)
        self.add(s - s_prev - q_sum + self.is_first() * claimed)


class _RelationsEvaluator(Evaluator):
    """Device evaluator that only records relations (interaction trace)."""

    def add(self, expr: Expr) -> None:
        pass

    def finalize_logup(self) -> None:
        pass


class Component:
    """Base class for AIR components."""

    name: str = "component"
    columns: Tuple[str, ...] = ()

    def __init__(self, log_size: int):
        self.log_size = log_size

    def define_constraints(self, e: Evaluator) -> None:
        raise NotImplementedError

    def relation_count(self) -> int:
        """Number of LogUp relation entries (dry run with dummies)."""
        return _counts(type(self))[0]

    def constraint_count(self) -> int:
        return _counts(type(self))[1]


@lru_cache(maxsize=None)
def _counts(cls) -> Tuple[int, int]:
    """(relations, constraints) of a component class: structural, so one
    host dry run with dummy values per class."""
    comp = cls(0)
    probe = _CountingEvaluator(comp)
    comp.define_constraints(probe)
    n_rel = len(probe.relations)
    e = Evaluator(comp, {c: qm31.ZERO for c in comp.columns}, [qm31.ZERO] * (n_rel + 1),
                  qm31.ZERO, qm31.ZERO, qm31.ZERO, _dummy_elements(), host=True)
    comp.define_constraints(e)
    return len(e.relations), len(e.constraints)


class _CountingEvaluator(Evaluator):
    def __init__(self, component):
        super().__init__(component, {c: qm31.ZERO for c in component.columns},
                         [], qm31.ZERO, qm31.ZERO, qm31.ZERO, _dummy_elements(), host=True)

    def finalize_logup(self) -> None:  # tolerate missing interaction columns
        pass


@lru_cache(maxsize=1)
def _dummy_elements() -> Dict[str, LookupElements]:
    return {
        "memory": LookupElements.dummy(3),
        "instruction": LookupElements.dummy(3),
        "processor": LookupElements.dummy(7),
    }


# ---------------------------------------------------------------------------
# Interaction trace (prover, device)
# ---------------------------------------------------------------------------

def _device_combine(els: Dict[str, torch.Tensor], values: List[torch.Tensor]) -> torch.Tensor:
    """sum alpha^i * v_i - z with device element tensors; values are M31
    tensors (or int constants)."""
    powers = els["alpha_powers"]
    acc = None
    for i, v in enumerate(values):
        term = powers[i].reshape(4, 1) * m31.wide(v) % P_INT
        acc = term if acc is None else (acc + term) % P_INT
    return (acc - els["z"].reshape(4, 1)) % P_INT


def _device_elements(elements: Dict[str, LookupElements], device) -> Dict[str, dict]:
    return {k: e.tensors(device) for k, e in elements.items()}


def logup_fractions(component: Component, main_cols: Dict[str, torch.Tensor],
                    is_first: torch.Tensor, els: Dict[str, dict]):
    """The LogUp fraction columns of the component's relations, pointwise
    over whatever rows main_cols hold: ([(4, n) int32 Q_k], (4, n) int64
    sum of the Q_k). els: the device elements (_device_elements)."""
    ev = _RelationsEvaluator(component, main_cols, [], None, is_first, None, els, host=False)
    component.define_constraints(ev)
    q_cols: List[torch.Tensor] = []
    total = None
    for rel in ev.relations:
        den = _device_combine(els[rel.elements_name], [v.v for v in rel.values])
        q = qm31.mul(rel.numerator._qm(den), qm31.inv(den))
        q_cols.append(q.to(torch.int32))
        total = q if total is None else (total + q) % P_INT
    return q_cols, total


def build_interaction_trace(
    component: Component,
    main_cols: Dict[str, torch.Tensor],
    elements: Dict[str, LookupElements],
) -> Tuple[List[torch.Tensor], tuple]:
    """The component's interaction columns on the TRACE domain:
    ([(4, N) int32 QM31 tensors Q_0..Q_{K-1}, S], claimed sum host tuple).

    S is the prefix sum of sum_k Q_k in coset LINEAR order (where p - g is
    the previous point), scattered back to bit-reversed storage; int64
    cumsum then % p is exact for N <= 2^32."""
    dev = next(iter(main_cols.values())).device
    n = 1 << component.log_size
    is_first = torch.zeros(n, dtype=torch.int64, device=dev)
    is_first[0] = 1
    q_cols, total = logup_fractions(component, main_cols, is_first,
                                    _device_elements(elements, dev))
    perm = coset_order_permutation(component.log_size, dev)
    s_lin = torch.cumsum(total[:, perm], dim=1) % P_INT
    s = torch.empty_like(s_lin)
    s[:, perm] = s_lin
    claimed = tuple(int(v) for v in s_lin[:, -1].cpu())
    return q_cols + [s.to(torch.int32)], claimed


# ---------------------------------------------------------------------------
# Composition (prover, device) and point evaluation (verifier, host)
# ---------------------------------------------------------------------------

def composition_contribution(
    component: Component,
    main_cols: Dict[str, torch.Tensor],
    interaction_cols: List[torch.Tensor],
    s_prev: torch.Tensor,
    is_first: torch.Tensor,
    claimed_sum: tuple,
    elements: Dict[str, LookupElements],
    alpha: tuple,
    alpha_offset: int,
    v_inv: torch.Tensor,
) -> Tuple[torch.Tensor, int]:
    """Sum_i alpha^(offset+i) * C_i / V over the evaluation domain.
    main_cols: M31 (N,) tensors; interaction_cols: QM31 (4, N) tensors
    [Q_0..Q_{K-1}, S]; s_prev: S rotated by -g; is_first: (N,);
    v_inv: (N,) inverse vanishing values. Returns ((4, N) int64, next
    alpha offset)."""
    dev = v_inv.device
    claimed = qm31.const(claimed_sum, dev)
    ev = Evaluator(component, main_cols, interaction_cols, s_prev, is_first,
                   claimed, _device_elements(elements, dev), host=False)
    component.define_constraints(ev)
    n_cons = len(ev.constraints)
    acc = None
    for i, c in enumerate(ev.constraints):
        w = qm31.const(qm31.h_pow(alpha, alpha_offset + i), dev)
        term = qm31.mul(w, c.v) if c.qm else w * m31.wide(c.v) % P_INT
        acc = term if acc is None else (acc + term) % P_INT
    return acc * m31.wide(v_inv) % P_INT, alpha_offset + n_cons


def evaluate_constraints_at_point(
    component: Component,
    main_values: Dict[str, tuple],
    interaction_values: List[tuple],
    s_prev_value: tuple,
    is_first_value: tuple,
    claimed_sum: tuple,
    elements: Dict[str, LookupElements],
) -> List[tuple]:
    """Evaluate every constraint at one out-of-domain point from sampled
    column values (verifier side). All values are host QM31 tuples."""
    ev = Evaluator(component, main_values, interaction_values, s_prev_value,
                   is_first_value, claimed_sum, elements, host=True)
    component.define_constraints(ev)
    return [c.v for c in ev.constraints]

