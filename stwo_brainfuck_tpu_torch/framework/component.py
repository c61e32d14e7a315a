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

# calls of the plain constraint path on CUDA tensors (the Expr evaluation,
# the LogUp fractions, the prefix sum): a prove on the card runs the
# kernels and leaves it at 0
PLAIN_CUDA_CALLS = 0

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
            den = self._denominator(rel)
            q_k = self._value(self._interaction[k])
            self.add(q_k * den - rel.numerator)
            q_sum = q_k if q_sum is None else q_sum + q_k
        s = self._value(self._interaction[n])
        s_prev = self._value(self._prev_sum)
        claimed = self._value(self._claimed_sum)
        self.add(s - s_prev - q_sum + self.is_first() * claimed)

    def _value(self, v) -> Expr:
        """An interaction, mask or claimed-sum value as an expression."""
        return Expr(v, self.host)

    def _denominator(self, rel: RelationEntry) -> Expr:
        """den = sum_j alpha^j v_j - z of a relation entry."""
        els = self._elements[rel.elements_name]
        if self.host:
            return Expr(els.combine_host([v.v for v in rel.values]), True)
        return Expr(_device_combine(els, [v.v for v in rel.values]), False)


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

    @property
    def n_main_columns(self) -> int:
        return len(self.columns)

    @property
    def n_interaction_columns(self) -> int:
        """QM31 interaction columns: one fraction column a relation entry,
        plus the prefix sum."""
        return self.relation_count() + 1

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
# Constraint programs: define_constraints recorded as straight-line code
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ConstraintProgram:
    """A component class's define_constraints as a straight-line program
    over one row, the source of the constraint kernels
    (ops/constraint_codegen.py) and of their emulation (emulate).

    Value v is the result of ops[v], M31 or QM31 as qm[v] says. An op is
    a tuple (name, *args):
      inputs    ("col", c) main column c; ("is_first",); ("inter", k)
                interaction column k (QM31, its coordinates 0..3);
                ("s_prev",) S(p - g); ("claimed",) the claimed sum;
                ("const", v) an integer constant;
      field ops ("add" | "sub" | "mul", a, b), with Expr._binary's M31 ->
                QM31 promotion; ("combine", elements, (v_0, ..)) sum_j
                alpha^j v_j - z with that element set's alpha powers and z;
                ("inv", a) the QM31 inverse (0 -> 0).
    Outputs: `constraints` (what Evaluator.constraints holds, in order),
    `relations` ((elements, numerator, values) a LogUp entry) and
    `fractions` (Q_k = numerator_k * den_k^-1 a relation). Structural: no
    log_size enters it."""

    component: str
    columns: Tuple[str, ...]
    ops: Tuple[tuple, ...]
    qm: Tuple[bool, ...]
    constraints: Tuple[int, ...]
    relations: Tuple[Tuple[str, int, Tuple[int, ...]], ...]
    fractions: Tuple[int, ...]

    def live(self, outputs: Sequence[int], leaves: Sequence[int] = ()) -> List[int]:
        """The ops that `outputs` need, in recorded order; the values in
        `leaves` are given, so what only they need is not."""
        need, given = set(outputs), set(leaves)
        for v in range(len(self.ops) - 1, -1, -1):
            if v in need and v not in given:
                need.update(_operands(self.ops[v]))
        return sorted(need)

    def inversions(self) -> List[Tuple[int, int]]:
        """(den_k, the "inv" op of den_k) of each relation k: the value ids
        of the denominators the fractions invert."""
        out = []
        for elements, _, values in self.relations:
            den = self.ops.index(("combine", elements, values))
            out.append((den, self.ops.index(("inv", den))))
        return out


def _operands(op: tuple) -> Tuple[int, ...]:
    if op[0] in ("add", "sub", "mul"):
        return op[1:]
    if op[0] == "inv":
        return (op[1],)
    if op[0] == "combine":
        return op[2]
    return ()


class _Var:
    """A recorded value: its id in the program and its field kind."""

    __slots__ = ("rec", "id", "qm")

    def __init__(self, rec: "_Recorder", vid: int, qm: bool):
        self.rec, self.id, self.qm = rec, vid, qm

    def _binary(self, name: str, other) -> "_Var":
        o = other if isinstance(other, _Var) else self.rec.op(("const", other % P_INT), False)
        return self.rec.op((name, self.id, o.id), self.qm or o.qm)

    def __add__(self, other):
        return self._binary("add", other)

    def __sub__(self, other):
        return self._binary("sub", other)

    def __rsub__(self, other):
        return self.rec.op(("const", other % P_INT), False)._binary("sub", self)

    def __mul__(self, other):
        return self._binary("mul", other)

    __radd__ = __add__
    __rmul__ = __mul__


class _Recorder:
    """The ops of a program being recorded, each distinct op once (the
    arithmetic is exact mod p, so a repeated subexpression is one value)."""

    def __init__(self):
        self.ops: List[tuple] = []
        self.qm: List[bool] = []
        self._seen: Dict[tuple, _Var] = {}

    def op(self, op: tuple, qm: bool) -> _Var:
        if op not in self._seen:
            self.ops.append(op)
            self.qm.append(qm)
            self._seen[op] = _Var(self, len(self.ops) - 1, qm)
        return self._seen[op]


class _RecordingEvaluator(Evaluator):
    """Runs define_constraints on recorded values (constraint_program)."""

    def __init__(self, component):
        self.rec = _Recorder()
        self.dens: List[_Var] = []
        n_inter = component.relation_count() + 1
        inter = [self.rec.op(("inter", k), True) for k in range(n_inter)]
        super().__init__(component, None, inter, self.rec.op(("s_prev",), True), None,
                         self.rec.op(("claimed",), True), None, host=False)

    def col(self, name: str) -> _Var:
        return self.rec.op(("col", self.component.columns.index(name)), False)

    def is_first(self) -> _Var:
        return self.rec.op(("is_first",), False)

    def _value(self, v):
        return v

    def _denominator(self, rel: RelationEntry) -> _Var:
        if any(v.qm for v in rel.values):
            raise TypeError(f"{self.component.name}: a QM31 value in a {rel.elements_name} "
                            f"relation")
        den = self.rec.op(("combine", rel.elements_name, tuple(v.id for v in rel.values)), True)
        self.dens.append(den)
        return den


@lru_cache(maxsize=None)
def constraint_program(cls) -> ConstraintProgram:
    """The recorded program of a component class (cached per class, like
    _counts)."""
    comp = cls(0)
    ev = _RecordingEvaluator(comp)
    comp.define_constraints(ev)
    fractions = [rel.numerator * ev.rec.op(("inv", den.id), True)
                 for rel, den in zip(ev.relations, ev.dens)]
    return ConstraintProgram(
        component=cls.name, columns=tuple(cls.columns), ops=tuple(ev.rec.ops),
        qm=tuple(ev.rec.qm), constraints=tuple(c.id for c in ev.constraints),
        relations=tuple((r.elements_name, r.numerator.id, tuple(v.id for v in r.values))
                        for r in ev.relations),
        fractions=tuple(q.id for q in fractions))


def emulate(program: ConstraintProgram, inputs: dict, outputs: Sequence[int],
            given: Optional[Dict[int, torch.Tensor]] = None) -> Dict[int, torch.Tensor]:
    """The values the kernels compute for `outputs` (value ids), every op
    they need run in recorded order with int64 torch ops on the inputs'
    device: M31 values (n,), QM31 values (4, n), canonical. inputs: "cols"
    (the main columns in program order), "is_first", "inter" (a (4, n)
    array or 4 rows an interaction column), "s_prev" ((4, n) or 4 rows),
    "claimed" (host QM31), "elements" (name -> LookupElements); only those
    the outputs need are read. `given`: values of some ops (value id ->
    tensor), taken as they are, with nothing computed for them."""
    vals: Dict[int, torch.Tensor] = dict(given or {})
    dev = _device(inputs)

    def qm_input(x) -> torch.Tensor:
        return (x if isinstance(x, torch.Tensor) else torch.stack(list(x))).to(torch.int64)

    for v in program.live(outputs, list(vals)):
        if v in vals:
            continue
        op = program.ops[v]
        kind = op[0]
        if kind == "col":
            out = inputs["cols"][op[1]].to(torch.int64)
        elif kind == "is_first":
            out = inputs["is_first"].to(torch.int64)
        elif kind == "inter":
            out = qm_input(inputs["inter"][op[1]])
        elif kind == "s_prev":
            out = qm_input(inputs["s_prev"])
        elif kind == "claimed":
            out = qm31.const(inputs["claimed"], dev)
        elif kind == "const":
            out = torch.tensor(op[1], dtype=torch.int64, device=dev)
        elif kind == "combine":
            els = inputs["elements"][op[1]]
            out = None
            for a, j in zip(els.alpha_powers, op[2]):
                term = qm31.const(a, vals[j].device) * vals[j] % P_INT
                out = term if out is None else (out + term) % P_INT
            out = (out - qm31.const(els.z, out.device)) % P_INT
        elif kind == "inv":
            out = qm31.inv(vals[op[1]])
        else:
            a, b = vals[op[1]], vals[op[2]]
            qa, qb = program.qm[op[1]], program.qm[op[2]]
            if kind == "mul" and qa and qb:
                out = qm31.mul(a, b)
            elif kind == "mul":  # M31 x M31, or each coordinate times the M31 value
                out = a * b % P_INT
            else:  # an M31 operand of a QM31 sum is (v, 0, 0, 0)
                a, b = (_as_qm(a) if qb and not qa else a), (_as_qm(b) if qa and not qb else b)
                out = (a + b) % P_INT if kind == "add" else (a - b) % P_INT
        vals[v] = out
    return vals


def _as_qm(v: torch.Tensor) -> torch.Tensor:
    """An M31 value (n,) or constant () as a QM31 one, (4, n) or (4, 1)."""
    z = torch.zeros_like(v)
    return torch.stack([v, z, z, z]).reshape(4, -1)


def _device(inputs: dict) -> torch.device:
    for x in inputs.values():
        while isinstance(x, (list, tuple)) and x:
            x = x[0]
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("emulate: no tensor among the inputs")


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
                    is_first: torch.Tensor, elements: Dict[str, LookupElements]):
    """The LogUp fraction columns of the component's relations, pointwise
    over whatever rows main_cols hold (a mesh shard's): ((K, 4, n) int32
    Q_k, (4, n) sum of the Q_k). On CUDA tensors one launch of the logup
    kernel (ops/constraint_kernels.py), on the CPU logup_fractions_plain."""
    if is_first.is_cuda:
        from ..ops import constraint_kernels

        return constraint_kernels.KERNELS.logup(component, main_cols, is_first, elements)
    return logup_fractions_plain(component, main_cols, is_first, elements)


def logup_fractions_plain(component: Component, main_cols: Dict[str, torch.Tensor],
                          is_first: torch.Tensor, elements: Dict[str, LookupElements]):
    """What the logup kernel computes, with the Expr path on any device
    ((K, 4, n) int32, (4, n) int64)."""
    global PLAIN_CUDA_CALLS
    if is_first.is_cuda:
        PLAIN_CUDA_CALLS += 1
    els = _device_elements(elements, is_first.device)
    ev = _RelationsEvaluator(component, main_cols, [], None, is_first, None, els, host=False)
    component.define_constraints(ev)
    q_cols: List[torch.Tensor] = []
    total = None
    for rel in ev.relations:
        den = _device_combine(els[rel.elements_name], [v.v for v in rel.values])
        q = qm31.mul(rel.numerator._qm(den), qm31.inv(den))
        q_cols.append(q.to(torch.int32))
        total = q if total is None else (total + q) % P_INT
    return torch.stack(q_cols), total


def prefix_sum(total: torch.Tensor, coset: bool = True,
               carry: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LogUp prefix sum of the (4, n) row sums `total`: ((4, n) int32
    S, (4,) int32 its last linear value, the claimed sum) on total's
    device. coset: total in bit-reversed storage order, summed in coset
    LINEAR order (where p - g is the previous point) and S scattered back;
    else total is already in linear order (a mesh shard's chunk) and `carry`
    ((4,) int32, the shards before it) is added. On CUDA tensors one launch
    of the scan kernel (ops/constraint_kernels.py), on the CPU
    prefix_sum_plain."""
    if total.is_cuda:
        from ..ops import constraint_kernels

        return constraint_kernels.KERNELS.scan(total, coset, carry)
    perm = coset_order_permutation(total.shape[1].bit_length() - 1, total.device) if coset else None
    return prefix_sum_plain(total, perm, carry)


def prefix_sum_plain(total: torch.Tensor, perm: Optional[torch.Tensor] = None,
                     carry: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the scan kernel computes, on any device: total gathered by
    `perm` (or as it is), an int64 cumsum plus `carry`, % p (exact for
    n <= 2^32), scattered back by `perm`; ((4, n) int32, (4,) int32 the
    last linear value)."""
    global PLAIN_CUDA_CALLS
    if total.is_cuda:
        PLAIN_CUDA_CALLS += 1
    s_lin = torch.cumsum(total if perm is None else total[:, perm], dim=1, dtype=torch.int64)
    if carry is not None:
        s_lin += carry.to(torch.int64)[:, None]
    s_lin %= P_INT
    if perm is None:
        s = s_lin
    else:
        s = torch.empty_like(s_lin)
        s[:, perm] = s_lin
    return s.to(torch.int32), s_lin[:, -1].to(torch.int32)


def build_interaction_trace_async(
    component: Component,
    main_cols: Dict[str, torch.Tensor],
    elements: Dict[str, LookupElements],
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The component's interaction columns on the TRACE domain:
    ([(4, N) int32 QM31 tensors Q_0..Q_{K-1}, S], the claimed sum as a (4,)
    int32 tensor on the columns' device, so that a caller pulls every
    component's in one copy). S is the prefix sum of sum_k Q_k in coset
    LINEAR order, scattered back to bit-reversed storage. On CUDA tensors
    one launch of the interaction kernel (ops/constraint_kernels.py), on the
    CPU interaction_plain."""
    dev = next(iter(main_cols.values())).device
    if dev.type == "cuda":
        from ..ops import constraint_kernels

        q_cols, s, claimed = constraint_kernels.KERNELS.interaction(component, main_cols, elements)
    else:
        q_cols, s, claimed = interaction_plain(component, main_cols, elements)
    return list(q_cols) + [s], claimed


def interaction_plain(component: Component, main_cols: Dict[str, torch.Tensor],
                      elements: Dict[str, LookupElements]
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the interaction kernel computes, on any device:
    logup_fractions_plain (is_first 1 at storage row 0, the first point)
    then prefix_sum_plain in coset order; ((K, 4, N) int32 Q_k, (4, N)
    int32 S, (4,) int32 the claimed sum)."""
    dev = next(iter(main_cols.values())).device
    n = 1 << component.log_size
    is_first = torch.zeros(n, dtype=torch.int32, device=dev)
    is_first[0] = 1
    q_cols, total = logup_fractions_plain(component, main_cols, is_first, elements)
    s, claimed = prefix_sum_plain(total, coset_order_permutation(component.log_size, dev))
    return q_cols, s, claimed


def build_interaction_trace(
    component: Component,
    main_cols: Dict[str, torch.Tensor],
    elements: Dict[str, LookupElements],
) -> Tuple[List[torch.Tensor], tuple]:
    """build_interaction_trace_async with the claimed sum pulled to the
    host: ([Q_0..Q_{K-1}, S], claimed sum host tuple)."""
    cols, claimed = build_interaction_trace_async(component, main_cols, elements)
    return cols, tuple(int(v) for v in claimed.cpu())


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
    alpha offset). The plain version of the composition kernel
    (composition_evaluate)."""
    global PLAIN_CUDA_CALLS
    dev = v_inv.device
    if dev.type == "cuda":
        PLAIN_CUDA_CALLS += 1
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


@dataclass
class CompositionMember:
    """One component's inputs to the composition at a segment's rows:
    main_cols M31 (m,) rows by column name; inter_rows the 4 (m,)
    coordinate rows of each interaction column [Q_0..Q_{K-1}, S]; s_rows
    the 4 rows S(p - g) is read from (S over the whole domain, read at the
    segment's rotation index, or, with no rotation, S(p - g) at the
    segment's rows); its claimed sum; alpha_offset, the exponent of its
    first weight (the constraints before it in the claim's order)."""
    component: Component
    main_cols: Dict[str, torch.Tensor]
    inter_rows: Sequence[torch.Tensor]
    s_rows: Sequence[torch.Tensor]
    claimed_sum: tuple
    alpha_offset: int


@dataclass
class CompositionSegment:
    """Storage positions offset .. offset + m - 1 of the blown-up domain of
    2^(log_size + log_blowup) positions (m the rows' length: the whole
    domain or a shard's chunk): its components, every one of log_size, in
    the claim's order; is_first (m,) rows; the int32 rotation index of the
    whole domain (core/fft.py rotation_index), or None where each member's
    s_rows are S(p - g) at the rows."""
    log_size: int
    members: List[CompositionMember]
    is_first: torch.Tensor
    rotation: Optional[torch.Tensor]
    offset: int = 0


def composition_evaluate(segments: Sequence[CompositionSegment],
                         elements: Dict[str, LookupElements], alpha: tuple,
                         log_blowup: int) -> List[torch.Tensor]:
    """Each segment's accumulator, (4, m) int32: sum over its members of
    sum_i alpha^(alpha_offset+i) * C_i / V_n at its positions. On CUDA rows
    one launch of the composition kernel for every segment (all on one
    device; V_n^-1's 2^log_blowup values a segment in its table); on the
    CPU composition_plain a member, summed a segment."""
    if segments and segments[0].is_first.is_cuda:
        from ..ops import constraint_kernels

        return constraint_kernels.KERNELS.composition(segments, elements, alpha, log_blowup)
    return [composition_segment_plain(seg, elements, alpha, log_blowup) for seg in segments]


def composition_segment_plain(seg: CompositionSegment, elements: Dict[str, LookupElements],
                              alpha: tuple, log_blowup: int) -> torch.Tensor:
    """A segment's accumulator with the plain version on any device:
    composition_plain a member, summed; (4, m) int32."""
    total = None
    for mem in seg.members:
        part, _ = composition_plain(mem.component, mem.main_cols, mem.inter_rows, mem.s_rows,
                                    seg.rotation, seg.is_first, mem.claimed_sum, elements, alpha,
                                    mem.alpha_offset, log_blowup, seg.offset)
        total = part if total is None else (total + part) % P_INT
    return total.to(torch.int32)


def composition_plain(component: Component, main_cols: Dict[str, torch.Tensor],
                      inter_rows: Sequence[torch.Tensor], s_rows: Sequence[torch.Tensor],
                      rotation: Optional[torch.Tensor], is_first: torch.Tensor,
                      claimed_sum: tuple, elements: Dict[str, LookupElements], alpha: tuple,
                      alpha_offset: int, log_blowup: int, offset: int = 0
                      ) -> Tuple[torch.Tensor, int]:
    """One component's part of a composition segment (CompositionMember's
    and CompositionSegment's fields), with the plain version on any device:
    composition_contribution at V_n^-1 of the domain's points
    (poly.vanishing_on_domain) and S(p - g) gathered (s_rows at
    rotation[offset + t], or with rotation None s_rows[t]); ((4, m) int64,
    next alpha offset)."""
    from ..core import poly

    n = component.log_size
    m = is_first.shape[0]
    v_inv = m31.inv(poly.vanishing_on_domain(n, n + log_blowup, is_first.device)[offset:offset + m])
    s_prev = torch.stack(list(s_rows))
    if rotation is not None:
        s_prev = s_prev[:, rotation[offset:offset + m].to(torch.int64)]
    inter = [torch.stack(list(inter_rows[4 * k:4 * k + 4])) for k in range(len(inter_rows) // 4)]
    return composition_contribution(component, main_cols, inter, s_prev, is_first, claimed_sum,
                                    elements, alpha, alpha_offset, v_inv)


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

