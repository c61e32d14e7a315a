"""Emit ``csrc/constraints.cu``: each component's constraint program as the
body of the hand-written constraint kernels (``csrc/constraint_kernel.cuh``).

    python -m stwo_brainfuck_tpu_torch.ops.constraint_codegen           # rewrite the file
    python -m stwo_brainfuck_tpu_torch.ops.constraint_codegen --check   # exit 1 if it is stale

One definition drives everything: ``components/defs.py``'s
``define_constraints``, recorded once per class as a straight-line
``framework.component.ConstraintProgram``, becomes one struct per component
with three ``__device__`` bodies, ``composition`` (the weighted sum of the
constraints at one row), and the relations' fractions Q_k split in two so
that the skeleton inverts many rows' denominators at once:
``denominators`` (den_k) and ``fractions`` (Q_k from the inverses), one
statement per op and every value a canonical ``uint32_t`` or ``Qm`` in
registers. The generated file is committed, so a build needs only the
sources in the repository; after editing ``components/defs.py`` run the
command above (the CPU tests fail while the committed file differs from
what this module emits).

The launch's tables, as the bodies read them (``ops/constraint_kernels.py``
packs them):

- pointers, a component's own: main column c at slot c (the logup launch
  has is_first at slot C; the interaction launch has none: is_first is t
  == 0); for composition interaction column k's coordinate rows at C + 4k
  .. + 3 and the rows S(p - g) is read from at C + 4 (K + 1) .. + 3
  (is_first is the launch segment's, read once a row by the skeleton);
- constant words, shared: the lookup elements, a set after another in
  ``ELEMENT_ORDER`` (alpha^0 .. alpha^(size - 1), then z; 4 words each);
- a component's own words (composition only): the claimed sum at
  ``OWN_CLAIMED``, then from ``OWN_WEIGHTS`` each constraint's weight
  alpha^(offset + i) (``weight_offsets``): an M31-valued constraint's 4
  coordinates, a QM31-valued one's 4 x 4 matrix of the product by it
  (row k: coordinate k of w e_j, j = 0 .. 3), so that w C is a sum of
  products of words.

The composition body sums every constraint's weighted value as one
64-bit sum of products a coordinate (``m31::mac``: the weight's
coordinate times an M31-valued constraint, a matrix row times a
QM31-valued one's coordinates), folded below 2^34 (``m31::fold64``)
after at most ``MAC_RUN`` products and reduced once (``m31::reduce64``)
at its end, and each LogUp denominator as ``qm31::qm_combine``, as the
interaction bodies do; its QM31 products take the skeleton's product
policy ``CompositionProduct``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from ..components.defs import COMPONENT_CLASSES, ELEMENT_SIZES
from ..framework.component import ConstraintProgram, constraint_program

OUTPUT = Path(__file__).resolve().parent.parent / "csrc" / "constraints.cu"
COMMAND = "python -m stwo_brainfuck_tpu_torch.ops.constraint_codegen"
ELEMENT_ORDER = ("memory", "instruction", "processor")


def element_words() -> Dict[str, Tuple[int, int]]:
    """name -> (word of alpha^0, word of z) in the constant table."""
    out, w = {}, 0
    for name in ELEMENT_ORDER:
        out[name] = (w, w + 4 * ELEMENT_SIZES[name])
        w += 4 * (ELEMENT_SIZES[name] + 1)
    return out


ELEMENT_WORDS = sum(4 * (ELEMENT_SIZES[k] + 1) for k in ELEMENT_ORDER)
OWN_CLAIMED = 0  # a component's own composition words: the claimed sum,
OWN_WEIGHTS = 4  # then its weights
MAC_RUN = 4      # products of canonical operands a 64-bit sum takes between folds


def composition_slots(program: ConstraintProgram) -> int:
    """Pointers a component takes in the composition launch: C columns, 4
    rows an interaction column, 4 rows of S(p - g)."""
    return len(program.columns) + 4 * (len(program.relations) + 1) + 4


def weight_offsets(program: ConstraintProgram) -> List[int]:
    """Each constraint's first weight word after OWN_WEIGHTS: 4 words an
    M31-valued constraint (its weight's coordinates), 16 a QM31-valued one
    (the 4 x 4 matrix of the product by its weight, row-major)."""
    out, w = [], 0
    for c in program.constraints:
        out.append(w)
        w += 16 if program.qm[c] else 4
    return out


def own_words(program: ConstraintProgram) -> int:
    """A component's own constant words in the composition launch: the
    claimed sum and its constraints' weight words."""
    return OWN_WEIGHTS + sum(16 if program.qm[c] else 4 for c in program.constraints)


def logup_slots(program: ConstraintProgram) -> int:
    return len(program.columns) + 1


def interaction_slots(program: ConstraintProgram) -> int:
    return len(program.columns)


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------

def _var(v: int) -> str:
    return f"v{v}"


def _expr(program: ConstraintProgram, v: int, composition: bool = False) -> str:
    """The C++ expression of value v's op (composition: as the composition
    body reads it, its QM31 products with the skeleton's product policy)."""
    op = program.ops[v]
    kind = op[0]
    n_cols = len(program.columns)
    policy = "<CompositionProduct>" if composition else ""
    if kind == "col":
        return f"r.col({op[1]})"
    if kind == "is_first":
        return "r.is_first()"
    if kind == "inter":
        return f"r.qcol({n_cols + 4 * op[1]})"
    if kind == "s_prev":
        return f"r.s_prev({n_cols + 4 * (len(program.relations) + 1)})"
    if kind == "claimed":
        return f"r.own_qm({OWN_CLAIMED})"
    if kind == "const":
        return f"{op[1]}u"
    if kind == "inv":
        return f"qm31::qm_inv({_var(op[1])})"
    if kind == "combine":
        alpha, z = element_words()[op[1]]
        vals = ", ".join(_var(x) for x in op[2])
        return f"qm31::qm_combine<{len(op[2])}>(r.consts, {alpha}, {{{vals}}}, {z})"
    a, b = op[1], op[2]
    qa, qb = program.qm[a], program.qm[b]
    if not (qa or qb):
        return f"m31::{kind}({_var(a)}, {_var(b)})"
    if kind == "mul":
        if qa and qb:
            return f"qm31::qm_mul{policy}({_var(a)}, {_var(b)})"
        q, s = (a, b) if qa else (b, a)
        return f"qm31::qm_mul_m31{policy}({_var(q)}, {_var(s)})"
    left = _var(a) if qa else f"qm31::qm_from_m31({_var(a)})"
    right = _var(b) if qb else f"qm31::qm_from_m31({_var(b)})"
    return f"qm31::qm_{kind}({left}, {right})"


def _statements(program: ConstraintProgram, outputs, given: Dict[int, str] = None,
                composition: bool = False) -> List[str]:
    """One statement a live op of `outputs`; the ops in `given` take the
    expression given."""
    given = given or {}
    lines = []
    for v in program.live(outputs, list(given)):
        ty = "Qm" if program.qm[v] else "uint32_t"
        expr = given[v] if v in given else _expr(program, v, composition)
        lines.append(f"    const {ty} {_var(v)} = {expr};")
    return lines


def _weighted_sum(program: ConstraintProgram) -> List[str]:
    """sum_i w_i C_i as one 64-bit sum of products a coordinate c
    (m31::mac over the weight words; m31::fold64 after every MAC_RUN
    products, the folded word, below 2^34, the next run's addend; one
    m31::reduce64 at the end): an M31-valued C_i adds w_i[c] C_i, a
    QM31-valued one row c of the matrix of the product by w_i times C_i's
    four coordinates."""
    terms = []
    for c, off in zip(program.constraints, weight_offsets(program)):
        if program.qm[c]:
            terms += [(f"{off} + 4 * c + {j}", f"{_var(c)}.{'abcd'[j]}") for j in range(4)]
        else:
            terms.append((f"{off} + c", _var(c)))
    lines = ["    uint32_t s[4];", "#pragma unroll", "    for (int c = 0; c < 4; ++c) {"]
    for j, (word, value) in enumerate(terms):
        if j and j % MAC_RUN == 0:
            lines.append("      x = m31::fold64(x);")
        lhs = "uint64_t x = m31::mac(0, " if j == 0 else "x = m31::mac(x, "
        lines.append(f"      {lhs}r.weight({word}), {value});")
    lines += ["      s[c] = m31::reduce64(x);", "    }", "    return {s[0], s[1], s[2], s[3]};"]
    return lines


def emit_component(cls) -> str:
    program = constraint_program(cls)
    name = cls.__name__
    lines = [
        f"// {program.component} (components/defs.py {cls.__name__}): columns "
        f"{len(program.columns)}, LogUp relations {len(program.relations)}, constraints "
        f"{len(program.constraints)}",
        f"struct {name} {{",
        f"  static constexpr int kColumns = {len(program.columns)};",
        f"  static constexpr int kRelations = {len(program.relations)};",
        f"  static constexpr int kConstraints = {len(program.constraints)};",
        f"  static constexpr int kOwnWords = {own_words(program)};",
        "",
        "  // sum_i w_i * C_i at one row (w_i the component's weights)",
        "  __device__ __forceinline__ static Qm composition(const Row& r) {",
        *_statements(program, program.constraints, composition=True),
        *_weighted_sum(program),
    ]
    inv = program.inversions()
    dens = [d for d, _ in inv]
    inverses = {}
    for k, (_, i) in enumerate(inv):
        inverses.setdefault(i, f"inv[{k}]")
    lines += [
        "  }",
        "",
        "  // den_k of each relation at one row",
        "  template <class R>",
        "  __device__ __forceinline__ static void denominators(const R& r, Qm* den) {",
        *_statements(program, dens),
        *[f"    den[{k}] = {_var(d)};" for k, d in enumerate(dens)],
        "  }",
        "",
        "  // Q_k = num_k * inv[k] of each relation at one row, inv[k] = den_k^-1",
        "  template <class R>",
        "  __device__ __forceinline__ static void fractions(const R& r, const Qm* inv, Qm* q) {",
        *_statements(program, program.fractions, inverses),
        *[f"    q[{k}] = {_var(f)};" for k, f in enumerate(program.fractions)],
        "  }",
        "};",
    ]
    return "\n".join(lines)


_HEAD = f"""\
// GENERATED by stwo_brainfuck_tpu_torch/ops/constraint_codegen.py from
// stwo_brainfuck_tpu_torch/components/defs.py; do not edit. Regenerate with
//
//     {COMMAND}
//
// The constraint kernels of the 13 components for Hopper (sm_90a): the
// bodies below, one struct a component, plug into the hand-written
// skeletons csrc/constraint_kernel.cuh (composition: one launch a prove,
// a thread a row of one segment, every component of the segment summed in
// registers, the vanishing inverse, the stores; logup and interaction: the
// batched inversion between the denominators and the fractions) and
// csrc/logup_scan.cuh (interaction: the coset scan). Each body is the
// component's recorded constraint program (framework/component.py
// ConstraintProgram), one statement an op.

#include <cstdint>
#include <cuda_runtime.h>

#include "constraint_kernel.cuh"

namespace constraints {{
namespace {{

using qm31::Qm;
"""


def emit() -> str:
    """The whole of csrc/constraints.cu."""
    parts = [_HEAD]
    for cls in COMPONENT_CLASSES:
        parts.append(emit_component(cls) + "\n")
    names = [c.__name__ for c in COMPONENT_CLASSES]
    cases_c = "\n".join(f"      case {i}: return {n}::composition(r);"
                        for i, n in enumerate(names))
    cases_l = "\n".join(f"    case {i}: return logup_entry<{n}>(ARGS);"
                        for i, n in enumerate(names))
    cases_i = "\n".join(f"    case {i}: return interaction_entry<{n}>(ARGS);"
                        for i, n in enumerate(names))
    cases_g = "\n".join(f"    case {i}: return interaction_geometry_of<{n}>(log_n, out);"
                        for i, n in enumerate(names))
    shape = "\n".join(f"    case {i}: return shape_of<{n}>(out);" for i, n in enumerate(names))
    label = "\n".join(f'    case {i}: return "{c.name}";' for i, c in enumerate(COMPONENT_CLASSES))
    parts.append(f"""\
// One component's body whatever the id (the probe below).
template <class C>
struct Only {{
  __device__ __forceinline__ static Qm composition(int, const Row& r) {{ return C::composition(r); }}
}};

// The composition launch's dispatch: component `id`'s body at one row.
struct Components {{
  __device__ __forceinline__ static Qm composition(int id, const Row& r) {{
    switch (id) {{
{cases_c}
    }}
    return {{0u, 0u, 0u, 0u}};
  }}
}};

}}  // namespace
}}  // namespace constraints

using namespace constraints;

extern "C" int constraints_components() {{ return {len(names)}; }}

extern "C" const char* constraints_component_name(int id) {{
  switch (id) {{
{label}
  }}
  return "";
}}

// out: columns, relations, constraints, pointer slots and own constant
// words of a component in the composition launch.
extern "C" int constraints_shape(int id, int* out) {{
  switch (id) {{
{shape}
  }}
  return static_cast<int>(cudaErrorInvalidValue);
}}

extern "C" int constraints_composition(const void* table, long long blocks, void* stream) {{
  return composition_entry<Components>(table, blocks, stream);
}}

// Never launched: the composition kernel with the processor's body alone,
// whose SASS tools/composition_limiter.py reads (a row's instructions of
// one component, the skeleton's included).
__global__ void __launch_bounds__(kThreads) composition_probe_processor(
    const unsigned long long* __restrict__ table) {{
  composition_row<Only<ProcessorComponent>>(table);
}}

#define ARGS table, n_ptrs, n_words, n, q, total, stream
extern "C" int constraints_logup(int id, const void* table, int n_ptrs, int n_words,
                                 long long n, void* q, void* total, void* stream) {{
  switch (id) {{
{cases_l}
  }}
  return static_cast<int>(cudaErrorInvalidValue);
}}
#undef ARGS

// out: col_log, row_log, tile_rows, tiles, rows_per_warp, on_chip of an
// interaction launch of 2^log_n rows on the current device, and the
// resident tiles it was planned for.
extern "C" int constraints_interaction_geometry(int id, int log_n, int* out) {{
  switch (id) {{
{cases_g}
  }}
  return static_cast<int>(cudaErrorInvalidValue);
}}

// The first n words of the interaction launches' head on the current device.
extern "C" int constraints_head(uint32_t* out, int n) {{ return logup_scan::head_words(out, n); }}

#define ARGS table, n_ptrs, n_words, log_n, q, s, claimed, work, sums, stream
extern "C" int constraints_interaction(int id, const void* table, int n_ptrs, int n_words,
                                       int log_n, void* q, void* s, void* claimed, void* work,
                                       void* sums, void* stream) {{
  switch (id) {{
{cases_i}
  }}
  return static_cast<int>(cudaErrorInvalidValue);
}}
#undef ARGS
""")
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# Work of a row, for the kernels' bounds
# ---------------------------------------------------------------------------

QM_INV = (62, 18)   # qm31::qm_inv: M31 products (42 of them m31_inv's chain), adds
M31_INV = 42        # qm31::m31_inv's addition chain
QM_MUL = (16, 16)   # qm31::qm_mul


def batch_inv_products(m: int) -> int:
    """qm31::batch_inv of m values: m - 1 running products, one m31_inv, two
    products a value on the way back."""
    return 3 * (m - 1) + M31_INV


def op_work(program: ConstraintProgram, outputs, inv: Tuple[int, int] = QM_INV
            ) -> Tuple[int, int]:
    """(M31 products, M31 adds and subtracts) of the emitted statements of
    the ops `outputs` need, as csrc/qm31.cuh and csrc/m31.cuh compute them;
    an "inv" op costs `inv` (QM_INV: qm31::qm_inv; a batched inversion
    passes its share besides the norm's inverse)."""
    products = adds = 0
    for v in program.live(outputs):
        op = program.ops[v]
        kind = op[0]
        if kind == "combine":
            products += 4 * len(op[2])
            adds += 4 * len(op[2])
        elif kind == "inv":
            products += inv[0]
            adds += inv[1]
        elif kind in ("add", "sub", "mul"):
            qa, qb = program.qm[op[1]], program.qm[op[2]]
            if kind != "mul":
                adds += 4 if (qa or qb) else 1
            elif qa and qb:
                products += QM_MUL[0]
                adds += QM_MUL[1]
            else:
                products += 4 if (qa or qb) else 1
    return products, adds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="emit csrc/constraints.cu")
    ap.add_argument("--check", action="store_true", help="exit 1 if the committed file is stale")
    args = ap.parse_args(argv)
    text = emit()
    if args.check:
        if OUTPUT.read_text() != text:
            print(f"{OUTPUT} is stale: run {COMMAND}", file=sys.stderr)
            return 1
        return 0
    OUTPUT.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
