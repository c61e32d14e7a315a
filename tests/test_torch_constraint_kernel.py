"""The constraint kernels' programs and emulation on the CPU, against the JAX
package, for every one of the 13 component classes.

- the recorded ConstraintProgram's counts equal constraint_count() and
  relation_count() of the port's and the JAX package's classes, and it
  holds each distinct op once;
- V_n^-1's 2^log_blowup values (core/poly.py vanishing_inverse_blocks), one
  a block of 2^log_size storage positions, are the JAX package's V_n^-1 on
  the whole domain;
- the composition launch's emulation (its table read back: the segments,
  each component's pointers, claimed sum and weights from one alpha
  ladder, V_n^-1 at position >> log_size, S(p - g) through the int32
  rotation index) equals JAX composition_contribution given the true
  V_n^-1 on the domain, bit for bit, at (log 4, blowup 1) and (4, 4); a
  launch of several sizes and components (a shard's chunk among them)
  equals composition_plain summed per size and the JAX package's
  contributions summed per size;
- every 64-bit sum of the emitted composition bodies (the weighted sum of
  the constraints, a QM31-valued one's weight as its product's 4 x 4
  matrix, folded below 2^34 between runs of at most four products) and
  of qm31::qm_combine (the denominators, reduced every four products from
  a canonical addend) stays below 2^64 with every operand p - 1;
- the logup launch's emulation equals the Q columns of JAX
  build_interaction_trace on the small program's real tables, and with the
  torch prefix sum its claimed sum;
- four chunks (offsets) equal the whole;
- the committed csrc/constraints.cu is what ops/constraint_codegen.py emits;
- the constant table's layout and the wrapper's refusals (before any
  library load);
- the composition kernel's C-type offsets do not wrap at 2^28 over 1 and 8
  shards, a segment a shard in one launch.
Tolerance everywhere: exact."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.components import defs as jdefs
from stwo_brainfuck_tpu.components import tables as jtables
from stwo_brainfuck_tpu.core import fft as jfft
from stwo_brainfuck_tpu.core import m31 as jm31
from stwo_brainfuck_tpu.core import poly as jpoly
from stwo_brainfuck_tpu.framework import component as jfw
from stwo_brainfuck_tpu.vm.compiler import compile_program
from stwo_brainfuck_tpu.vm.machine import create_test_machine
from stwo_brainfuck_tpu_torch import convert
from stwo_brainfuck_tpu_torch.components import defs as tdefs
from stwo_brainfuck_tpu_torch.core import fft as tfft
from stwo_brainfuck_tpu_torch.core import poly as tpoly
from stwo_brainfuck_tpu_torch.core.m31 import P_INT
from stwo_brainfuck_tpu_torch.framework import component as tfw
from stwo_brainfuck_tpu_torch.ops import constraint_codegen as cg
from stwo_brainfuck_tpu_torch.ops import constraint_kernels as ck

torch.set_num_threads(1)
P = 2**31 - 1
NAMES = [c.name for c in jdefs.COMPONENT_CLASSES]
T_CLASSES = {c.name: c for c in tdefs.COMPONENT_CLASSES}
J_CLASSES = {c.name: c for c in jdefs.COMPONENT_CLASSES}


def _elements(cls_mod, seed):
    rng = np.random.default_rng(seed)

    def felt():
        return tuple(int(v) for v in rng.integers(0, P, 4))

    return {k: cls_mod.LookupElements(z=felt(), alpha=felt(), size=s)
            for k, s in jdefs.ELEMENT_SIZES.items()}


@pytest.fixture(scope="module")
def tables():
    m = create_test_machine(compile_program("+++>,<[>+.<-]"), b"\x01")
    m.execute()
    return jtables.all_tables(m.trace(), m.program())


@pytest.mark.parametrize("name", NAMES)
def test_program_counts_match_the_classes(name):
    program = tfw.constraint_program(T_CLASSES[name])
    tc, jc = T_CLASSES[name](5), J_CLASSES[name](5)
    assert len(program.constraints) == tc.constraint_count() == jc.constraint_count()
    assert len(program.relations) == len(program.fractions) == tc.relation_count() \
        == jc.relation_count()
    assert program.columns == tc.columns
    assert program is tfw.constraint_program(T_CLASSES[name])  # cached per class
    assert program == tfw.constraint_program.__wrapped__(T_CLASSES[name])  # no log_size


@pytest.mark.parametrize("name", NAMES)
def test_program_records_each_op_once(name):
    """A repeated subexpression is one value: no op appears twice, and the
    emitted bodies hold no statement twice."""
    program = tfw.constraint_program(T_CLASSES[name])
    assert len(set(program.ops)) == len(program.ops)
    body = cg.emit_component(T_CLASSES[name])
    composition, rest = body.split("static void denominators(")
    dens, fractions = rest.split("static void fractions(")
    inv = program.inversions()
    for text, outputs, leaves in ((composition, program.constraints, ()),
                                  (dens, [d for d, _ in inv], ()),
                                  (fractions, program.fractions, [i for _, i in inv])):
        exprs = re.findall(r"^    const \w+ v\d+ = (.*);$", text, re.M)
        assert len(exprs) == len(set(exprs)) == len(program.live(outputs, leaves))


@pytest.mark.parametrize("log, blow", [(1, 0), (1, 1), (2, 4), (4, 1), (4, 4), (6, 3), (9, 2)])
def test_vanishing_inverse_blocks_are_the_domain_values(log, blow):
    """V_n^-1 on the blown-up domain in storage order is constant on blocks
    of 2^n positions: the 2^blowup values the composition kernel reads at
    position >> n, against the JAX package's V_n^-1 on every position."""
    want = jm31.np_inv(jpoly.vanishing_on_domain(log, log + blow))
    blocks = np.array(tpoly.vanishing_inverse_blocks(log, blow), dtype=np.int64)
    assert blocks.shape == (1 << blow,)
    np.testing.assert_array_equal(blocks[np.arange(1 << (log + blow)) >> log], want)


def _composition_case(name, log, blow, seed):
    """Seeded inputs of one component's composition on its blown-up domain:
    numpy main columns, interaction columns, is_first, claimed sum, alpha."""
    n = 1 << (log + blow)
    rng = np.random.default_rng(seed)
    jc = J_CLASSES[name](log)
    main = {c: rng.integers(0, P, n, dtype=np.uint32) for c in jc.columns}
    inter = [rng.integers(0, P, (4, n), dtype=np.uint32) for _ in range(jc.relation_count() + 1)]
    is_first = rng.integers(0, P, n, dtype=np.uint32)
    claimed = tuple(int(v) for v in rng.integers(0, P, 4))
    alpha = tuple(int(v) for v in rng.integers(0, P, 4))
    return main, inter, is_first, claimed, alpha


def _torch_args(name, log, blow, main, inter, is_first):
    tmain = {c: convert.to_torch(v) for c, v in main.items()}
    rows = [convert.to_torch(q[c]) for q in inter for c in range(4)]
    return tmain, rows, rows[-4:], tfft.rotation_index(log, blow, "cpu"), convert.to_torch(is_first)


def _segment(name, log, blow, main, inter, is_first, claimed, alpha_offset, part=None,
             rows_given=False):
    """One component's composition segment of torch rows (a chunk `part`
    of the domain at its offset, S(p - g) given as rows when rows_given)."""
    tmain, rows, s_rows, rot, isf = _torch_args(name, log, blow, main, inter, is_first)
    part = part or slice(0, isf.shape[0])
    if rows_given:
        s_rows = [r[part] for r in torch.stack(s_rows)[:, rot.to(torch.int64)]]
        rot = None
    member = tfw.CompositionMember(T_CLASSES[name](log), {k: v[part] for k, v in tmain.items()},
                                   [r[part] for r in rows], s_rows, claimed, alpha_offset)
    return tfw.CompositionSegment(log, [member], isf[part], rot, part.start)


def _jax_part(name, log, blow, main, inter, is_first, claimed, alpha, alpha_offset, els,
              part=None):
    """JAX composition_contribution of one component at positions `part` of
    its blown-up domain (S(p - g) gathered on the whole domain)."""
    part = part or slice(0, 1 << (log + blow))
    s_prev = inter[-1][:, jfft.rotation_permutation(log, blow, 1)]
    v_inv = jm31.np_inv(jpoly.vanishing_on_domain(log, log + blow))
    want, nxt = jfw.composition_contribution(
        J_CLASSES[name](log), {c: jnp.asarray(v[part]) for c, v in main.items()},
        [jnp.asarray(q[:, part]) for q in inter], jnp.asarray(s_prev[:, part]),
        jnp.asarray(is_first[part]), claimed, els, alpha, alpha_offset,
        jnp.asarray(v_inv[part]))
    return np.asarray(want).astype(np.int64), nxt


@pytest.mark.parametrize("blow", [1, 4])
@pytest.mark.parametrize("name", NAMES)
def test_composition_emulation_matches_jax(name, blow):
    log = 4
    main, inter, is_first, claimed, alpha = _composition_case(name, log, blow, NAMES.index(name))
    want, off_j = _jax_part(name, log, blow, main, inter, is_first, claimed, alpha, 7,
                            _elements(jfw, 2))
    seg = _segment(name, log, blow, main, inter, is_first, claimed, 7)
    assert off_j == 7 + len(tfw.constraint_program(T_CLASSES[name]).constraints)
    (got,) = ck.emulate_composition([seg], _elements(tfw, 2), alpha, blow)
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    # the CPU dispatch (the plain version with the domain's V_n^-1) agrees
    (plain,) = tfw.composition_evaluate([seg], _elements(tfw, 2), alpha, blow)
    np.testing.assert_array_equal(convert.to_numpy(plain), want)


@pytest.mark.parametrize("name", NAMES)
def test_composition_chunks_equal_the_whole(name):
    """Four chunks at their offsets, S(p - g) given as rows (the mesh's
    form) and through the rotation index, as eight segments of one launch,
    equal one segment over the whole domain."""
    log, blow, chunks = 4, 2, 4
    main, inter, is_first, claimed, alpha = _composition_case(name, log, blow, 50)
    els = _elements(tfw, 4)
    whole = ck.emulate_composition(
        [_segment(name, log, blow, main, inter, is_first, claimed, 3)], els, alpha, blow)[0]
    c = (1 << (log + blow)) // chunks
    parts = [slice(i * c, (i + 1) * c) for i in range(chunks)]
    segs = [_segment(name, log, blow, main, inter, is_first, claimed, 3, part, given)
            for part in parts for given in (True, False)]
    got = ck.emulate_composition(segs, els, alpha, blow)
    plain = tfw.composition_evaluate(segs, els, alpha, blow)
    for k, part in enumerate(p for p in parts for _ in (0, 1)):
        assert torch.equal(got[k], whole[:, part])
        assert torch.equal(plain[k], whole[:, part])


# a launch of several sizes: (log_size, components), blowup 2, the memory and
# processor size also as the second of two shard chunks
LAUNCH = [(5, ["memory", "program"]), (3, ["instruction", "processor", "end_of_execution"]),
          (4, ["jump_if_not_zero", "jump_if_zero", "input_instruction", "left_instruction",
               "minus_instruction", "output_instruction", "plus_instruction",
               "right_instruction"])]


def _launch_case(seed, blow):
    """The LAUNCH sizes' components in the claim's order with their alpha
    offsets and seeded numpy inputs (one is_first a size)."""
    offsets, off = {}, 0
    for name in NAMES:
        offsets[name] = off
        off += len(tfw.constraint_program(T_CLASSES[name]).constraints)
    cases = {}
    for log, names in LAUNCH:
        for name in names:
            main, inter, is_first, claimed, alpha = _composition_case(
                name, log, blow, seed + NAMES.index(name))
            shared = cases[names[0]][2] if name != names[0] else is_first
            cases[name] = (main, inter, shared, claimed, alpha)
    return offsets, cases


@pytest.mark.parametrize("shard", [None, 1])
def test_one_launch_of_every_size_matches_plain_and_jax(shard):
    """One composition launch over three sizes and all 13 components (the
    emulation read from its table), whole domains or each size's second of
    two shard chunks (S(p - g) given as rows, its offset in the table),
    against composition_plain summed per size and the JAX package's
    composition_contribution summed per size."""
    blow = 2
    offsets, cases = _launch_case(70, blow)
    els_t, els_j = _elements(tfw, 6), _elements(jfw, 6)
    alpha = cases["memory"][4]
    segments, wants = [], []
    for log, names in LAUNCH:
        n = 1 << (log + blow)
        part = slice(0, n) if shard is None else slice(n // 2, n)
        want = 0
        members = []
        for name in names:
            main, inter, is_first, claimed, _ = cases[name]
            seg = _segment(name, log, blow, main, inter, is_first, claimed, offsets[name], part,
                           rows_given=shard is not None)
            members += seg.members
            w, _ = _jax_part(name, log, blow, main, inter, is_first, claimed, alpha,
                             offsets[name], els_j, part)
            want = (want + w) % P
        segments.append(tfw.CompositionSegment(log, members, seg.is_first, seg.rotation,
                                               seg.offset))
        wants.append(want)
    got = ck.emulate_composition(segments, els_t, alpha, blow)
    plain = [tfw.composition_segment_plain(s, els_t, alpha, blow) for s in segments]
    for g, p_, w in zip(got, plain, wants):
        np.testing.assert_array_equal(convert.to_numpy(g), w)
        assert torch.equal(g, p_)


def test_composition_table_layout():
    """plan_composition's words: the header, a segment's and a component's
    words, the pointers, the lookup elements, each component's claimed sum
    and weights (alpha^(offset + i) from one ladder) and each segment's
    V_n^-1 values."""
    blow = 1
    offsets, cases = _launch_case(80, blow)
    segs = []
    for log, names in LAUNCH[:2]:
        members = []
        for name in names:
            main, inter, is_first, claimed, _ = cases[name]
            seg = _segment(name, log, blow, main, inter, is_first, claimed, offsets[name])
            members += seg.members
        segs.append(tfw.CompositionSegment(log, members, seg.is_first, seg.rotation))
    els, alpha = _elements(tfw, 8), (5, 6, 7, 8)
    words, blocks = ck.plan_composition(segs, els, alpha, blow, [111, 222])
    head = words.view(np.uint64)
    n_members = sum(len(s.members) for s in segs)
    assert tuple(head[:4]) == (2, blocks, n_members, head[3])
    assert blocks == sum(-(-(1 << (log + blow)) // ck.THREADS) for log, _ in LAUNCH[:2])
    consts = words[2 * int(head[3]):]
    assert (consts[:cg.ELEMENT_WORDS] == ck.pack_constants(els)).all()
    j, first_block = 0, 0
    for s, seg in enumerate(segs):
        f = dict(zip(ck.SEGMENT_FIELDS, (int(v) for v in head[4 + 10 * s:14 + 10 * s])))
        m = 1 << (seg.log_size + blow)
        assert (f["first_block"], f["rows"], f["offset"], f["log_size"]) == \
            (first_block, m, 0, seg.log_size)
        assert (f["rot"], f["acc"], f["is_first"]) == \
            (seg.rotation.data_ptr(), (111, 222)[s], seg.is_first.data_ptr())
        assert (f["first_member"], f["members"]) == (j, len(seg.members))
        assert tuple(consts[f["v_inv"]:f["v_inv"] + 2]) == \
            tpoly.vanishing_inverse_blocks(seg.log_size, blow)
        first_block += -(-m // ck.THREADS)
        for mem in seg.members:
            k = 4 + 10 * len(segs) + 3 * j
            cid, ptr, own = (int(v) for v in head[k:k + 3])
            assert cid == ck.COMPONENT_IDS[mem.component.name]
            rows = [mem.main_cols[c] for c in mem.component.columns] + list(mem.inter_rows) + \
                list(mem.s_rows)
            assert list(head[ptr:ptr + len(rows)]) == [r.data_ptr() for r in rows]
            program = tfw.constraint_program(type(mem.component))
            assert tuple(consts[own + cg.OWN_CLAIMED:own + cg.OWN_CLAIMED + 4]) == \
                mem.claimed_sum
            rng = np.random.default_rng(j)
            for i, (c, off) in enumerate(zip(program.constraints, cg.weight_offsets(program))):
                w = tfw.qm31.h_pow(alpha, mem.alpha_offset + i)
                at = own + cg.OWN_WEIGHTS + off
                if not program.qm[c]:
                    assert tuple(int(v) for v in consts[at:at + 4]) == w
                    continue
                # the product's matrix: M x = w x for any x
                mat = consts[at:at + 16].astype(object).reshape(4, 4)
                for _ in range(3):
                    x = np.array([int(v) for v in rng.integers(0, P, 4)], dtype=object)
                    assert tuple(int(v) for v in mat.dot(x) % P) == \
                        tfw.qm31.h_mul(w, tuple(int(v) for v in x))
            assert own + cg.own_words(program) <= len(consts)
            j += 1


def _mac_runs(text):
    """The 64-bit sums of an emitted composition body: for each, the
    products between folds, run by run (a run starts from 0 or from a
    folded word), and every line of the sum is a mac, a fold or the last
    reduction."""
    runs, cur = [], None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("uint64_t x = m31::mac(0, "):
            cur = [1]
        elif line.startswith("x = m31::mac(x, "):
            cur[-1] += 1
        elif line == "x = m31::fold64(x);":
            cur.append(0)
        elif line == "s[c] = m31::reduce64(x);":
            runs.append(cur)
            cur = None
        else:
            assert cur is None or "x" not in line.split("//")[0], line
    assert cur is None
    return runs


def _fold64(x):
    """m31::fold64 in Python integers."""
    assert 0 <= x < 1 << 64
    return (x & P) + (x >> 31)


def _reduce64(x):
    """m31::reduce64 in Python integers."""
    y = _fold64(x)
    r = (y & P) + (y >> 31)
    return r - P if r >= P else r


@pytest.mark.parametrize("name", NAMES)
def test_emitted_sums_of_products_stay_below_2_64(name):
    """Every 64-bit accumulator of the composition body (each constraint's
    weight words times its value's coordinates) takes at most MAC_RUN
    products between folds, on an addend that is 0 or a folded word; with
    every operand p - 1 (the worst case, and the largest folded word, just
    below 2^34, as the addend) each run's sum stays below 2^64, fold64
    keeps it mod p below 2^34, and the last reduce64 gives the sum mod p.
    Each qm31::qm_combine (the LogUp denominators, csrc/qm31.cuh) reduces
    every four terms from an addend p - z (canonical, 0 where z = 0): the
    same bound for its longest run."""
    program = tfw.constraint_program(T_CLASSES[name])
    body = cg.emit_component(T_CLASSES[name])
    text = body.split("static void denominators(")[0]
    runs = _mac_runs(text)
    terms = sum(4 if program.qm[c] else 1 for c in program.constraints)
    assert len(runs) == 1
    top_fold = (P) + ((1 << 64) - 1 >> 31)  # fold64 of any 64-bit word is at most this
    assert top_fold < 1 << 34
    for run in runs:
        assert sum(run) == terms
        assert all(1 <= k <= cg.MAC_RUN for k in run)
        worst, total = 0, 0  # the largest addend a run may start from; the true sum
        for i, k in enumerate(run):
            x = worst + k * (P - 1) ** 2
            assert x < 1 << 64
            total += k * (P - 1) ** 2
            if i + 1 < len(run):
                assert _fold64(x) <= top_fold and _fold64(x) % P == x % P
                worst = top_fold
        assert _reduce64(x) == x % P < P
        # the sum itself, folded run by run as the kernel folds it
        acc = 0
        for i, k in enumerate(run):
            acc += k * (P - 1) ** 2
            acc = _fold64(acc) if i + 1 < len(run) else _reduce64(acc)
        assert acc == total % P
    # qm_combine's schedule, as csrc/qm31.cuh writes it
    head = (cg.OUTPUT.parent / "qm31.cuh").read_text()
    combine = head[head.index("__device__ __forceinline__ Qm qm_combine("):]
    combine = combine[:combine.index("\n}\n")]
    assert "uint64_t acc = zc ? m31::kP - zc : 0u;" in combine
    assert "if (j % 4 == 3 && j + 1 < N) acc = m31::reduce64(acc);" in combine
    sizes = [len(op[2]) for op in program.ops if op[0] == "combine"]
    assert ("qm31::qm_combine<" in text) == bool(sizes)
    for n in sizes:
        first = min(n, 4)
        assert (P - 1) + first * (P - 1) ** 2 < 1 << 64
        assert _reduce64((P - 1) + first * (P - 1) ** 2) == ((P - 1) + first * (P - 1) ** 2) % P


@pytest.mark.parametrize("name", NAMES)
def test_logup_emulation_matches_jax(name, tables):
    cols = tables[name]
    log = int(np.log2(len(next(iter(cols.values())))))
    want, claimed_j = jfw.build_interaction_trace(
        J_CLASSES[name](log), {c: jnp.asarray(v) for c, v in cols.items()}, _elements(jfw, 1))
    comp = T_CLASSES[name](log)
    tmain = {c: convert.to_torch(v) for c, v in cols.items()}
    is_first = torch.zeros(1 << log, dtype=torch.int32)
    is_first[0] = 1
    q, total = ck.emulate_logup(comp, tmain, is_first, _elements(tfw, 1))
    assert q.shape[0] == len(want) - 1
    for g, w in zip(q, want[:-1]):
        np.testing.assert_array_equal(convert.to_numpy(g), np.asarray(w))
    perm = tfw.coset_order_permutation(log, "cpu")
    s_lin = torch.cumsum(total[:, perm], dim=1, dtype=torch.int64) % P_INT
    assert tuple(int(v) for v in s_lin[:, -1]) == claimed_j
    s = torch.empty_like(s_lin)
    s[:, perm] = s_lin
    np.testing.assert_array_equal(convert.to_numpy(s), np.asarray(want[-1]))
    # and the CPU dispatch, four chunks of it
    pq, ptotal = tfw.logup_fractions(comp, tmain, is_first, _elements(tfw, 1))
    assert torch.equal(pq, q) and torch.equal(ptotal % P_INT, total.to(torch.int64))
    c = (1 << log) // 4
    for i in range(4):
        part = slice(i * c, (i + 1) * c)
        cq, ctotal = ck.emulate_logup(comp, {k: v[part] for k, v in tmain.items()},
                                      is_first[part], _elements(tfw, 1))
        assert torch.equal(cq, q[:, :, part]) and torch.equal(ctotal, total[:, part])


def test_committed_source_is_what_the_emitter_writes():
    assert cg.OUTPUT.read_text() == cg.emit(), f"regenerate: {cg.COMMAND}"
    assert cg.main(["--check"]) == 0


def test_emitted_bodies_follow_the_programs():
    """Each struct's counts, and one statement a live op."""
    text = cg.emit()
    for cls in tdefs.COMPONENT_CLASSES:
        p = tfw.constraint_program(cls)
        body = text[text.index(f"struct {cls.__name__} {{"):]
        body = body[:body.index("\n};")]
        assert f"kColumns = {len(p.columns)};" in body
        assert f"kRelations = {len(p.relations)};" in body
        assert f"kConstraints = {len(p.constraints)};" in body
        assert body.count(" = ") - 3 >= len(p.live(p.constraints)) + len(p.live(p.fractions))


def test_constant_table_layout():
    els = _elements(tfw, 9)
    alpha = (5, 6, 7, 8)
    w = ck.weights(alpha, 3, 4)
    assert w == [tfw.qm31.h_pow(alpha, 3 + i) for i in range(4)]
    assert ck.weights(alpha, 0, 7)[3:] == w
    words = ck.pack_constants(els)
    assert words.dtype == np.uint32 and words.size == cg.ELEMENT_WORDS == 64
    for name, (a0, z) in cg.element_words().items():
        for j, a in enumerate(els[name].alpha_powers):
            assert tuple(words[a0 + 4 * j:a0 + 4 * j + 4]) == a
        assert tuple(words[z:z + 4]) == els[name].z
    for cls in tdefs.COMPONENT_CLASSES:
        p = tfw.constraint_program(cls)
        assert ck.shape_of(cls) == (len(p.columns), len(p.relations), len(p.constraints),
                                    len(p.columns) + 4 * (len(p.relations) + 1) + 4,
                                    cg.OWN_WEIGHTS + sum(16 if p.qm[c] else 4
                                                         for c in p.constraints))
    w = (3, 5, 7, 11)
    assert ck.weight_words(w, False) == list(w)
    mat = np.array(ck.weight_words(w, True), dtype=object).reshape(4, 4)
    for x in ((1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1), (9, 8, P - 7, P - 1)):
        assert tuple(int(v) for v in mat.dot(np.array(x, dtype=object)) % P) == \
            tfw.qm31.h_mul(w, x)
    table = ck.pack_table([2**40 + 3, 7], np.array([9, 10], np.uint32))
    assert list(table) == [3, 2**8, 7, 0, 9, 10]


def test_kernel_wrappers_refuse_before_loading(monkeypatch):
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(ck.KERNELS.lib, "load", no_load)
    name = "processor"
    log, blow = 4, 1
    main, inter, is_first, claimed, alpha = _composition_case(name, log, blow, 3)
    tmain, rows, s_rows, rot, isf = _torch_args(name, log, blow, main, inter, is_first)
    comp, els = T_CLASSES[name](log), _elements(tfw, 2)

    def comp_call(segs=None, blowup=blow):
        if segs is None:
            segs = [tfw.CompositionSegment(log, [tfw.CompositionMember(
                comp, tmain, rows, s_rows, claimed, 0)], isf, rot)]
        return ck.KERNELS.composition(segs, els, alpha, blowup)

    def seg(**kw):
        member = dict(component=comp, main_cols=tmain, inter_rows=rows, s_rows=s_rows,
                      claimed_sum=claimed, alpha_offset=0)
        fields = dict(log_size=log, is_first=isf, rotation=rot, offset=0)
        for k, v in kw.items():
            (member if k in member else fields)[k] = v
        return [tfw.CompositionSegment(members=[tfw.CompositionMember(**member)], **fields)]

    with pytest.raises(ValueError, match="CUDA"):
        comp_call()
    with pytest.raises(TypeError, match="int32"):
        comp_call(seg(main_cols={**tmain, "clk": tmain["clk"].to(torch.int64)}))
    with pytest.raises(ValueError, match="shape"):
        comp_call(seg(main_cols={**tmain, "clk": tmain["clk"][:-1]}))
    with pytest.raises(ValueError, match="positions"):
        comp_call(seg(offset=1))
    with pytest.raises(ValueError, match="interaction rows"):
        comp_call(seg(inter_rows=rows[:-4]))
    with pytest.raises(ValueError, match="log_size"):
        comp_call(seg(component=T_CLASSES[name](log + 1)))
    with pytest.raises(ValueError, match="no segments"):
        comp_call([])
    with pytest.raises(ValueError, match="S rows"):
        comp_call(seg(s_rows=[r[:-1] for r in s_rows]))
    lmain = {c: v[:16] for c, v in tmain.items()}
    with pytest.raises(ValueError, match="CUDA"):
        ck.KERNELS.logup(comp, lmain, isf[:16], els)
    with pytest.raises(TypeError, match="int32"):
        ck.KERNELS.logup(comp, lmain, isf[:16].to(torch.int64), els)
    with pytest.raises(ValueError, match="shape"):
        ck.KERNELS.logup(comp, lmain, isf[:15], els)
    assert ck.KERNELS.launches == dict.fromkeys(ck.FAMILIES, 0)


class _C:
    """Integer arithmetic in one C type, raising where the C value would wrap."""

    def __init__(self, bits: int, signed: bool):
        self.lo = -(1 << (bits - 1)) if signed else 0
        self.hi = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1

    def __call__(self, value: int, what: str) -> int:
        assert self.lo <= value <= self.hi, f"{what} = {value} wraps"
        return value


U32, U64 = _C(32, False), _C(64, False)


@pytest.mark.parametrize("shards", [1, 8])
def test_composition_offsets_at_2_28_do_not_wrap(shards):
    """csrc/constraint_kernel.cuh's composition_kernel over a 2^28-row
    blown-up domain (a 2^24 component at blowup 4) as `shards` segments of
    one launch (a chunk each, its offset in the table): for each segment's
    first and last thread, the grid's block, the uint32 row and position,
    the rotation index's read, V_n^-1's word, the (4, n) words of the
    accumulator (size_t) and the grid."""
    log, blow, threads = 24, 4, 256
    assert threads == ck.THREADS
    eval_log = log + blow
    n = (1 << eval_log) // shards
    first_block = 0
    for shard in range(shards):
        offset = shard * n
        seg_blocks = -(-n // threads)
        for t in (0, n - 1):
            b = U32(first_block + t // threads, "blockIdx.x")
            t32 = U32(U32((b - first_block) * threads, "(b - first block) * kThreads")
                      + t % threads, "t")
            assert t32 == t
            pos = U32(offset + t32, "offset + t")
            assert pos < 1 << eval_log  # rot[pos], the rotation index's length
            assert U32(pos >> log, "pos >> log_size") < 1 << blow  # V_n^-1's words
            assert U64(3 * n + t32, "3 * n + t (size_t)") < 4 * n
        first_block += seg_blocks
    assert U32(first_block, "blocks") <= 2**31 - 1
    # the logup kernel's outputs: (K, 4, n) words at 4 k n + c n + t, a
    # 2^24-row component with 3 relations
    n = 1 << log
    assert U64(4 * 2 * n + 3 * n + n - 1, "4 * k * n + 3 * n + t") < 3 * 4 * n
