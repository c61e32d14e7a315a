"""The table build's meta pass on the device (components/device_build.
device_meta, here on CPU tensors) and the table kernel's per-row rules
(ops/table_kernels.emulate), on the CPU, bit for bit:

- the meta pass against the port's and the JAX package's host pass
  (build_meta), field by field, on the programs of
  tests/test_torch_device_build.py, at the edges (a one-row trace, no
  jumps, an unmatched opcode, a memory count that lands on a power of two,
  bucket=False) and on random short programs (hypothesis);
- the kernel's emulation (the block's search of the memory starts in
  rounds of 256 probes, each successor from lane + 1 but for lane 31 and
  the last row) against its plain version (tables_plain), the host
  builders and the JAX package's device build, for every component, with
  clk gaps longer than a block, a new memory cell at rows 32 and 256,
  tables shorter than a warp and the last row of every matrix;
- the block search against torch.searchsorted, in at most
  ceil(log_256 n) rounds;
- build_tables(..., "cpu") against the JAX package's device build and the
  host builders;
- the launch table's layout and the refusal of shapes whose 32-bit
  indices would wrap.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from stwo_brainfuck_tpu.components import device_build as jbuild
from stwo_brainfuck_tpu_torch import air, tracing
from stwo_brainfuck_tpu_torch.components import device_build as tbuild
from stwo_brainfuck_tpu_torch.components import tables as T
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES
from stwo_brainfuck_tpu_torch.ops import table_kernels as K
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

with open(os.path.join(ROOT, "programs", "fib19_io.bf")) as _f:
    FIB19_IO = _f.read()

PROGRAMS = {
    "io_loop": ("+++>,<[>+.<-]", b"\x01"),
    "no_jumps": ("+++.", b""),
    "empty_ops": (",.", b"\x05"),
    "fib-ish": ("++>+<[->>+>+<<<]", b""),
    "fib19_io": (FIB19_IO, bytes([5])),
    # 16 rows, no clk gap: the memory table's height is exactly 2^4 (no pad)
    "pow2_memory": ("+" * 15, b""),
    # 64 rows on two cells: 2^6 memory rows, gaps included; the second
    # cell starts at memory row 32, lane 0 of the second warp
    "pow2_gaps": ("+" * 31 + ">" + "+" * 31, b""),
    # the second cell starts at memory row 256, a thread's second row
    "tile_edge": ("+" * 255 + ">" + "+" * 255, b""),
    # the second cell starts at memory row 1024, the second block's first row
    "block_edge": ("+" * 1023 + ">" + "+" * 1023, b""),
}


def _run(code: str, inp: bytes):
    m = create_test_machine(compile_program(code), inp)
    m.execute()
    return m.trace(), m.program()


def _one_row():
    """A trace of one row (its end row) with a one-instruction program: the
    memory order has no gaps to take."""
    return np.zeros((1, 7), np.uint32), [int(ord("+"))]


def _scaled(trace: np.ndarray, factor: int) -> np.ndarray:
    """The trace with every clk multiplied by `factor`: clk gaps of
    factor - 1 rows between a cell's accesses, longer than a block."""
    out = trace.copy()
    out[:, 0] *= np.uint32(factor)
    return out


def _assert_meta(dm, want, where: str) -> None:
    """The device meta pass's fields against a host pass's TraceMeta."""
    assert list(dm.claim.items()) == list(want.claim.items()), where
    assert (dm.n_steps, dm.plen, dm.k) == (want.n_steps, want.plen, want.k), where
    for field in ("order_mem", "counts_mem", "order_ins", "prog_cols", "eoe_cols"):
        got = getattr(dm, field).numpy().astype(np.int64)
        np.testing.assert_array_equal(got, getattr(want, field).astype(np.int64),
                                      err_msg=f"{where}: {field}")
    sel = dm.sel
    assert list(sel) == list(want.sel), where
    for key in want.sel:
        assert sel[key].dtype == torch.int32
        np.testing.assert_array_equal(sel[key].numpy(), want.sel[key], err_msg=f"{where}: {key}")


def _assert_tables(mats, trace, program, bucket, where: str) -> None:
    """name -> matrix against the host builders (components/tables.py)."""
    host = T.all_tables(trace, program, bucket)
    assert list(mats) == list(air.CLAIM_ORDER), where
    for cls in COMPONENT_CLASSES:
        got = mats[cls.name]
        assert got.dtype == torch.int32 and got.is_contiguous(), (where, cls.name)
        want = np.stack([host[cls.name][c] for c in cls.columns])
        assert tuple(got.shape) == want.shape, (where, cls.name)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want,
                                      err_msg=f"{where}: {cls.name}")


CASES = [(name, bucket) for name in PROGRAMS for bucket in (True, False)]


@pytest.mark.parametrize("name, bucket", CASES)
def test_device_meta_matches_build_meta(name, bucket):
    trace, program = _run(*PROGRAMS[name])
    dm = tbuild.device_meta(trace, program, "cpu", bucket)
    _assert_meta(dm, tbuild.build_meta(trace, program, bucket), f"{name} port")
    _assert_meta(dm, jbuild.build_meta(trace, program, bucket), f"{name} jax")
    assert tuple(dm.claim) == air.CLAIM_ORDER


@pytest.mark.parametrize("bucket", [True, False])
def test_device_meta_one_row_trace(bucket):
    trace, program = _one_row()
    dm = tbuild.device_meta(trace, program, "cpu", bucket)
    _assert_meta(dm, tbuild.build_meta(trace, program, bucket), "one row")
    _assert_meta(dm, jbuild.build_meta(trace, program, bucket), "one row, jax")
    assert dm.n_mem_real == 1 and len(dm.ops) == 0 and not any(dm.k.values())
    assert dm.claim["memory"] == T.MIN_LOG_SIZE


def test_device_meta_edges():
    """No jumps and unmatched opcodes give k = 0 tables of 2^4 rows padded
    from clk 0; a memory of exactly 2^4 rows takes no pad."""
    trace, program = _run(*PROGRAMS["no_jumps"])
    dm = tbuild.device_meta(trace, program, "cpu")
    assert dm.k["jump_if_zero"] == dm.k["jump_if_not_zero"] == dm.k["left_instruction"] == 0
    assert dm.claim["jump_if_zero"] == T.MIN_LOG_SIZE
    trace, program = _run(*PROGRAMS["pow2_memory"])
    dm = tbuild.device_meta(trace, program, "cpu")
    assert dm.n_mem_real == 16 and dm.claim["memory"] == 4
    assert int(dm.counts_mem[-1]) == 1


def test_device_meta_refuses_bad_end_rows():
    trace, program = _run(*PROGRAMS["io_loop"])
    for bad in (trace[:-1], np.concatenate([trace, trace[-1:]])):
        with pytest.raises(T.InvalidEndOfExecution):
            tbuild.build_meta(bad, program)
        with pytest.raises(T.InvalidEndOfExecution):
            tbuild.device_meta(bad, program, "cpu")


def test_device_meta_does_not_rely_on_clk_order():
    """Rows whose clk is not their row index (scaled, then the rows of one
    cell shuffled among themselves): the (mp, clk) sort still matches
    np.lexsort, ties included."""
    trace, program = _run(*PROGRAMS["fib-ish"])
    rng = np.random.default_rng(7)
    t = _scaled(trace, 3)
    t[:, 0] = rng.permutation(t[:, 0])
    t[::5, 0] = t[0, 0]  # equal keys: the sort must keep row order
    t[-1] = trace[-1]
    for bucket in (True, False):
        dm = tbuild.device_meta(t, program, "cpu", bucket)
        _assert_meta(dm, tbuild.build_meta(t, program, bucket), "shuffled clk")
        np.testing.assert_array_equal(dm.order_mem.numpy(),
                                      np.lexsort((t[:, 0], t[:, 4])))


@pytest.mark.parametrize("name, bucket", CASES)
def test_emulated_kernel_matches_plain_and_host(name, bucket):
    trace, program = _run(*PROGRAMS[name])
    dm = tbuild.device_meta(trace, program, "cpu", bucket)
    got = K.emulate(dm)
    plain = K.tables_plain(dm.rows.T, dm, "cpu")
    for key in plain:
        assert torch.equal(got[key], plain[key]), (name, key)
    _assert_tables(got, trace, program, bucket, name)


@pytest.mark.parametrize("factor", [2, 300, 1000])
@pytest.mark.parametrize("name", ["io_loop", "fib-ish", "pow2_gaps"])
def test_emulated_kernel_with_long_clk_gaps(name, factor):
    """clk gaps of up to 999 rows: blocks inside one gap, windows whose rows
    all map to one sorted row, a new sorted row on a block's first row."""
    trace, program = _run(*PROGRAMS[name])
    t = _scaled(trace, factor)
    dm = tbuild.device_meta(t, program, "cpu", False)
    assert dm.n_mem_real > K.THREADS or factor == 2
    got = K.emulate(dm)
    plain = K.tables_plain(dm.rows.T, dm, "cpu")
    for key in plain:
        assert torch.equal(got[key], plain[key]), (name, factor, key)
    _assert_tables(got, t, program, False, f"{name} x{factor}")


def test_emulated_kernel_one_row_trace():
    trace, program = _one_row()
    dm = tbuild.device_meta(trace, program, "cpu")
    got = K.emulate(dm)
    plain = K.tables_plain(dm.rows.T, dm, "cpu")
    for key in plain:
        assert torch.equal(got[key], plain[key]), key
    jmats = jbuild.build_device_tables(trace, jbuild.build_meta(trace, program))
    for key in plain:
        np.testing.assert_array_equal(got[key].numpy().view(np.uint32), np.asarray(jmats[key]),
                                      err_msg=key)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_build_tables_cpu_matches_jax_and_host(name):
    trace, program = _run(*PROGRAMS[name])
    claim, mats = tbuild.build_tables(trace, program, "cpu")
    jmeta = jbuild.build_meta(trace, program)
    assert list(claim.items()) == list(jmeta.claim.items())
    jmats = jbuild.build_device_tables(trace, jmeta)
    for key in mats:
        np.testing.assert_array_equal(mats[key].numpy().view(np.uint32), np.asarray(jmats[key]),
                                      err_msg=key)
    _assert_tables(mats, trace, program, True, name)


def test_build_tables_bucket_false_matches_host():
    trace, program = _run(*PROGRAMS["fib19_io"])
    claim, mats = tbuild.build_tables(trace, program, "cpu", bucket=False)
    assert claim == tbuild.build_meta(trace, program, bucket=False).claim
    _assert_tables(mats, trace, program, False, "bucket=False")


@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 4096, 65537, 1 << 22])
def test_block_search_matches_searchsorted(n):
    """The kernel's block search over n strictly increasing starts (counts
    of 1 to 600) for block starts across the whole range: the largest i
    with starts[i] <= r0, in at most ceil(log_256 n) rounds."""
    rng = np.random.default_rng(n)
    counts = torch.as_tensor(rng.integers(1, 600, n), dtype=torch.int64)
    starts = torch.cumsum(counts, 0) - counts
    top = int(starts[-1] + counts[-1])
    r0 = torch.unique(torch.cat([
        torch.as_tensor(rng.integers(0, top, 300)) // K.THREADS * K.THREADS,
        torch.tensor([0, (top - 1) // K.THREADS * K.THREADS])]))
    got, rounds = K.block_search(starts, r0)
    assert torch.equal(got, torch.searchsorted(starts, r0, right=True) - 1)
    limit = 0
    while K.THREADS ** limit < n:
        limit += 1
    assert rounds <= limit


@pytest.mark.parametrize("name, factor", [("pow2_gaps", 1), ("tile_edge", 1), ("tile_edge", 7),
                                          ("block_edge", 1), ("block_edge", 7), ("no_jumps", 1),
                                          ("io_loop", 257)])
def test_emulated_kernel_at_lane_and_block_edges(name, factor):
    """Successors at rows 31/32, 255/256 and 1023/1024 (a new memory cell on
    lane 0 of a warp, of a thread's next row, of a block; with factor 7 a
    gap run across that row), tables shorter than one warp (2^4 rows) and
    the last row of every matrix, against the plain build, the host
    builders and the JAX package's device build (_build_tables_jit)."""
    trace, program = _run(*PROGRAMS[name])
    t = _scaled(trace, factor)
    dm = tbuild.device_meta(t, program, "cpu", False)
    got = K.emulate(dm)
    plain = K.tables_plain(dm.rows.T, dm, "cpu")
    jmats = jbuild.build_device_tables(t, jbuild.build_meta(t, program, False))
    for key in plain:
        assert torch.equal(got[key], plain[key]), key
        np.testing.assert_array_equal(got[key].numpy().view(np.uint32), np.asarray(jmats[key]),
                                      err_msg=key)
        last = got[key][:, -1]
        assert torch.equal(last, plain[key][:, -1]), key
    _assert_tables(got, t, program, False, f"{name} x{factor}")
    mem = got["memory"]
    if name == "pow2_gaps":  # memory row 32 starts the second cell: row 31's successor
        assert int(mem[3, 32]) == 0 and int(mem[7, 31]) == 0 and int(mem[5, 31]) == 1
    edge = {"tile_edge": 256, "block_edge": 1024}.get(name)
    if edge and factor == 1:
        assert int(mem[3, edge]) == 0 and int(mem[7, edge - 1]) == 0
        assert int(mem[5, edge - 1]) == 1
    if edge and factor == 7:  # one gap run across the edge
        first = edge - 1 - (edge - 1) % 7  # the source row before it
        assert [int(v) for v in mem[3, first:first + 7]] == [0, 1, 1, 1, 1, 1, 1]
        assert int(mem[7, edge - 1]) == 1 and int(mem[4, edge - 1]) == int(mem[0, edge - 1]) + 1
    if name == "no_jumps":
        assert min(m.shape[1] for m in got.values()) < 32


def test_build_tables_pulls_once():
    trace, program = _run(*PROGRAMS["io_loop"])
    meta_calls = tbuild.META_CALLS
    with tracing.record(0) as rec:
        tbuild.build_tables(trace, program, "cpu")
    assert tracing.sync_counts([rec]) == {"sync.tables": 1}
    assert tbuild.META_CALLS == meta_calls  # the host pass does not run


@st.composite
def _programs(draw):
    """A short terminating program and its input: straight-line ops and
    counted loops '+' * a '[>' body '<-]' on a cell no op has touched (the
    pointer first moves past every visited cell; the body moves none)."""
    parts, reads, at, seen = [], 0, 0, 0
    for _ in range(draw(st.integers(1, 6))):
        if draw(st.booleans()):
            ops = draw(st.text(alphabet="+-.,>", min_size=1, max_size=12))
            reads += ops.count(",")
            at += ops.count(">")
            seen = max(seen, at)
            parts.append(ops)
        else:
            a = draw(st.integers(1, 5))
            body = draw(st.text(alphabet="+-.,", max_size=5))
            reads += a * body.count(",")
            parts.append(">" * (seen + 1 - at) + "+" * a + "[>" + body + "<-]")
            at = seen + 1
            seen = at + 1
    inp = bytes(draw(st.lists(st.integers(0, 255), min_size=reads, max_size=reads)))
    return "".join(parts), inp


@settings(max_examples=25, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_programs(), st.booleans())
def test_device_meta_and_kernel_rules_on_random_programs(prog, bucket):
    code, inp = prog
    trace, program = _run(code, inp)
    assert len(trace) <= 1 << 12
    dm = tbuild.device_meta(trace, program, "cpu", bucket)
    _assert_meta(dm, tbuild.build_meta(trace, program, bucket), code)
    _assert_meta(dm, jbuild.build_meta(trace, program, bucket), code)
    got = K.emulate(dm)
    plain = K.tables_plain(dm.rows.T, dm, "cpu")
    for key in plain:
        assert torch.equal(got[key], plain[key]), (code, key)
    _assert_tables(got, trace, program, bucket, code)


def test_plan_layout():
    trace, program = _run(*PROGRAMS["fib19_io"])
    dm = tbuild.device_meta(trace, program, "cpu")
    words = K.plan(dm)
    assert words.dtype == np.int64
    assert len(words) == K.HEADER_WORDS + len(air.CLAIM_ORDER) * K.TABLE_WORDS
    assert list(words[7:11]) == [dm.n_steps, dm.plen, dm.prog_cap, len(air.CLAIM_ORDER)]
    block = 0
    for t, name in enumerate(air.CLAIM_ORDER):
        e = K.HEADER_WORDS + t * K.TABLE_WORDS
        height = 1 << dm.claim[name]
        assert list(words[e + 1:e + 7]) == [K.KIND[name], height, block, K.COLUMNS[name],
                                           dm.k.get(name, 0), dm.op_start.get(name, 0)]
        block += -(-height // K.BLOCK_ROWS)
    assert words[11] == block
    assert K.bound_bytes(dm) == 4 * (7 * len(trace) + sum(K.COLUMNS[n] << dm.claim[n]
                                                          for n in air.CLAIM_ORDER))


@pytest.mark.parametrize("field, value", [("memory", 30), ("processor", 29),
                                           ("jump_if_zero", 29)])
def test_plan_refuses_wrapping_indices(field, value):
    trace, program = _run(*PROGRAMS["io_loop"])
    dm = tbuild.device_meta(trace, program, "cpu")
    dm.claim = {**dm.claim, field: value}
    with pytest.raises(ValueError, match="32 bits"):
        K.plan(dm)


def test_plan_refuses_a_long_trace():
    fake = SimpleNamespace(claim=dict.fromkeys(air.CLAIM_ORDER, 4), n_steps=(1 << 32) // 7 + 1,
                           plen=1, prog_cap=16, k={}, op_start={})
    with pytest.raises(ValueError, match="32 bits"):
        K.plan(fake)
