"""The constraint kernels' programs and emulation on the CPU, against the JAX
package, for every one of the 13 component classes.

- the recorded ConstraintProgram's counts equal constraint_count() and
  relation_count() of the port's and the JAX package's classes, and it
  holds each distinct op once;
- V_n^-1's 2^log_blowup values (core/poly.py vanishing_inverse_blocks), one
  a block of 2^log_size storage positions, are the JAX package's V_n^-1 on
  the whole domain;
- the composition launch's emulation (the program's ops, the weights, V_n^-1
  from the constant table at position >> log_size, S(p - g) through the
  int32 rotation index) equals JAX composition_contribution given the true
  V_n^-1 on the domain, bit for bit, at (log 4, blowup 1) and (4, 4);
- the logup launch's emulation equals the Q columns of JAX
  build_interaction_trace on the small program's real tables, and with the
  torch prefix sum its claimed sum;
- four chunks (offsets) equal the whole;
- the committed csrc/constraints.cu is what ops/constraint_codegen.py emits;
- the constant table's layout and the wrapper's refusals (before any
  library load);
- the composition kernel's C-type offsets do not wrap at 2^28 over 1 and 8
  shards.
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


@pytest.mark.parametrize("blow", [1, 4])
@pytest.mark.parametrize("name", NAMES)
def test_composition_emulation_matches_jax(name, blow):
    log = 4
    main, inter, is_first, claimed, alpha = _composition_case(name, log, blow, NAMES.index(name))
    s_prev = inter[-1][:, jfft.rotation_permutation(log, blow, 1)]
    v_inv = jm31.np_inv(jpoly.vanishing_on_domain(log, log + blow))
    want, off_j = jfw.composition_contribution(
        J_CLASSES[name](log), {c: jnp.asarray(v) for c, v in main.items()},
        [jnp.asarray(q) for q in inter], jnp.asarray(s_prev), jnp.asarray(is_first), claimed,
        _elements(jfw, 2), alpha, 7, jnp.asarray(v_inv))
    tmain, rows, s_rows, rot, isf = _torch_args(name, log, blow, main, inter, is_first)
    got, off_t = ck.emulate_composition(T_CLASSES[name](log), tmain, rows, s_rows, rot, isf,
                                        claimed, _elements(tfw, 2), alpha, 7, blow, None)
    assert off_t == off_j
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))
    # the CPU dispatch (the plain version with the domain's V_n^-1) agrees
    plain, _ = tfw.composition_accumulate(T_CLASSES[name](log), tmain, rows, s_rows, rot, isf,
                                          claimed, _elements(tfw, 2), alpha, 7, blow, None)
    np.testing.assert_array_equal(convert.to_numpy(plain), np.asarray(want))


@pytest.mark.parametrize("name", NAMES)
def test_composition_chunks_equal_the_whole(name):
    """Four chunks at their offsets, S(p - g) given as rows (the mesh's
    form) and through the rotation index, accumulated onto a previous sum,
    equal one launch over the whole domain."""
    log, blow, chunks = 4, 2, 4
    main, inter, is_first, claimed, alpha = _composition_case(name, log, blow, 50)
    comp = T_CLASSES[name](log)
    tmain, rows, s_rows, rot, isf = _torch_args(name, log, blow, main, inter, is_first)
    els = _elements(tfw, 4)
    prev = convert.to_torch(np.random.default_rng(51).integers(0, P, (4, isf.shape[0]),
                                                               dtype=np.uint32))
    whole, nxt = ck.emulate_composition(comp, tmain, rows, s_rows, rot, isf, claimed, els, alpha,
                                        3, blow, prev)
    s_prev = torch.stack(s_rows)[:, rot.to(torch.int64)]
    c = isf.shape[0] // chunks
    for i in range(chunks):
        part = slice(i * c, (i + 1) * c)
        sub_main = {k: v[part] for k, v in tmain.items()}
        for given, rotation in (([r[part] for r in s_prev], None), (s_rows, rot)):
            got, n2 = ck.emulate_composition(comp, sub_main, [r[part] for r in rows], given,
                                             rotation, isf[part], claimed, els, alpha, 3, blow,
                                             prev[:, part].contiguous(), offset=i * c)
            assert n2 == nxt
            assert torch.equal(got, whole[:, part])
        acc = prev[:, part].clone()
        out, _ = tfw.composition_accumulate(comp, sub_main, [r[part] for r in rows],
                                            [r[part] for r in s_prev], None, isf[part], claimed,
                                            els, alpha, 3, blow, acc, offset=i * c)
        assert out is acc and torch.equal(acc, whole[:, part])


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
    words = ck.pack_constants(els, (1, 2, 3, 4), w, (11, 12))
    assert words.dtype == np.uint32 and words.size == cg.WEIGHTS_WORD + 16 + 2
    for name, (a0, z) in cg.element_words().items():
        for j, a in enumerate(els[name].alpha_powers):
            assert tuple(words[a0 + 4 * j:a0 + 4 * j + 4]) == a
        assert tuple(words[z:z + 4]) == els[name].z
    assert tuple(words[cg.CLAIMED_WORD:cg.CLAIMED_WORD + 4]) == (1, 2, 3, 4)
    for i in range(4):
        assert tuple(words[cg.WEIGHTS_WORD + 4 * i:cg.WEIGHTS_WORD + 4 * i + 4]) == w[i]
    assert tuple(words[cg.WEIGHTS_WORD + 16:]) == (11, 12)  # V_n^-1's values
    assert ck.pack_constants(els).size == cg.ELEMENT_WORDS == 64
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

    def comp_call(**kw):
        args = dict(component=comp, main_cols=tmain, inter_rows=rows, s_rows=s_rows,
                    rotation=rot, is_first=isf, claimed_sum=claimed, elements=els, alpha=alpha,
                    alpha_offset=0, log_blowup=blow, acc=None, offset=0)
        args.update(kw)
        return ck.KERNELS.composition(**args)

    with pytest.raises(ValueError, match="CUDA"):
        comp_call()
    with pytest.raises(TypeError, match="int32"):
        comp_call(main_cols={**tmain, "clk": tmain["clk"].to(torch.int64)})
    with pytest.raises(ValueError, match="shape"):
        comp_call(main_cols={**tmain, "clk": tmain["clk"][:-1]})
    with pytest.raises(ValueError, match="positions"):
        comp_call(offset=1)
    with pytest.raises(ValueError, match="interaction rows"):
        comp_call(inter_rows=rows[:-4])
    with pytest.raises(ValueError, match="acc"):
        comp_call(acc=torch.zeros((4, 3), dtype=torch.int32))
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
    blown-up domain (a 2^24 component at blowup 4) in `shards` chunks: for
    each shard's first and last thread, the uint32 row and position, the
    rotation index's read, V_n^-1's word in the constant table, the (4, n)
    words of the accumulator (size_t) and the grid."""
    log, blow, threads = 24, 4, 256
    eval_log = log + blow
    n = (1 << eval_log) // shards
    for shard in range(shards):
        offset = shard * n
        blocks = U32(-(-n // threads), "blocks")
        assert blocks <= 2**31 - 1
        for t in (0, n - 1):
            bid, tid = divmod(t, threads)
            t32 = U32(U32(bid * threads, "blockIdx.x * kThreads") + tid, "t")
            pos = U32(offset + t32, "a.offset + t")
            assert pos < 1 << eval_log  # rot[pos], the rotation index's length
            assert U32(pos >> log, "pos >> a.log_size") < 1 << blow  # V_n^-1's words
            assert U64(3 * n + t32, "3 * n + t (size_t)") < 4 * n
    # the logup kernel's outputs: (K, 4, n) words at 4 k n + c n + t, a
    # 2^24-row component with 3 relations
    n = 1 << log
    assert U64(4 * 2 * n + 3 * n + n - 1, "4 * k * n + 3 * n + t") < 3 * 4 * n
