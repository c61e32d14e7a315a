"""The OODS sampling of the port against the JAX package's, bit for bit:
the vectorised half bases against stwo_brainfuck_tpu/core/poly.py:53
half_bases_at_point, and poly.sample_groups (the plain version, and the
OODS kernel's emulation, ops/oods_kernels.emulate: the persistent grid's
spans, each thread's quad of a big row and its rows, the packed small
rows, the factors built from each group's point, the flushes in a random
order) against poly._sample_tensor_jit a group, whole and as a mesh
shard's chunks, at several grid sizes. The walk covers every coefficient
once; the kernel's spans and table layout, and the wrapper's refusals (it
checks before it loads the library, and at load that the library's
constants and spans are its own)."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.core import poly as jpoly
from stwo_brainfuck_tpu_torch.core import poly as tpoly
from stwo_brainfuck_tpu_torch.ops import oods_kernels

torch.set_num_threads(1)
P = 2**31 - 1


def _felt(rng):
    return tuple(int(v) for v in rng.integers(0, P, 4))


def _point(rng):
    return (_felt(rng), _felt(rng))


def _jax_sample(log_size, point, rows) -> np.ndarray:
    b_lo, b_hi = jpoly.half_bases_at_point(log_size, point)
    return np.asarray(jpoly._sample_tensor_jit(tuple(jnp.asarray(r) for r in rows),
                                               jnp.asarray(b_lo), jnp.asarray(b_hi)))


@pytest.mark.parametrize("log_size", [1, 2, 3, 8, 11, 16, 18])
def test_vectorised_half_bases_match_jax(log_size):
    rng = np.random.default_rng(log_size)
    for point in (_point(rng), ((1, 0, 0, 0), (0, 0, 0, 0))):
        got = tpoly.half_bases_at_point(log_size, point)
        want = jpoly.half_bases_at_point(log_size, point)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert tpoly._point_factors(log_size, point) == jpoly._point_factors(log_size, point)


def _groups(seed, spec):
    """(log_size, point, rows) groups: spec lists (log_size, rows), the rows
    seeded uint32 values below p."""
    rng = np.random.default_rng(seed)
    out = []
    for log_size, n_rows in spec:
        rows = rng.integers(0, P, (n_rows, 1 << log_size), dtype=np.uint32)
        out.append((log_size, _point(rng), rows))
    return out


def _torch_groups(groups):
    return [(lg, pt, [torch.as_tensor(r.astype(np.int32)) for r in rows])
            for lg, pt, rows in groups]


SPECS = {
    "small": [(1, 2), (2, 3), (3, 1), (4, 5), (5, 2)],
    "mid": [(8, 3), (9, 2), (12, 2), (13, 1)],
    "large": [(16, 2), (17, 1), (18, 1)],
    # a prove's mix: many 2^4-2^6 rows packed into small rows beside big ones
    "packed": [(4, 40), (6, 30), (5, 9), (11, 2), (15, 1)],
    "odd": [(7, 3), (11, 2), (13, 1), (17, 1)],
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_sample_groups_and_emulation_match_jax(name):
    groups = _groups(len(name), SPECS[name])
    want = np.concatenate([_jax_sample(lg, pt, rows) for lg, pt, rows in groups], axis=1)
    tg = _torch_groups(groups)
    plain = tpoly.sample_groups(tg)
    assert plain.dtype == torch.int32 and tuple(plain.shape) == want.shape
    np.testing.assert_array_equal(plain.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(oods_kernels.emulate(tg, seed=7).numpy(), plain.numpy())


@pytest.mark.parametrize("blocks", [1, 2, 5, 64, 1000])
def test_emulation_at_any_grid(blocks):
    """The persistent grid's spans cut the rows anywhere (mid-member, a
    block with only small rows or none); the flushes in any order give the
    JAX package's samples."""
    groups = _groups(blocks, [(4, 7), (6, 5), (10, 2), (12, 3), (13, 1)])
    want = np.concatenate([_jax_sample(lg, pt, rows) for lg, pt, rows in groups], axis=1)
    got = oods_kernels.emulate(_torch_groups(groups), seed=blocks, max_blocks=blocks)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_shard_chunks_sum_to_the_whole(shards):
    """Each shard's launch takes its rows' chunks at their offsets (rows too
    short to split whole in shard 0's launch, None elsewhere); the chunks'
    samples, plain and emulated, sum mod p to the JAX package's."""
    groups = _groups(shards, [(2, 2), (6, 3), (11, 2), (14, 2)])
    tg = _torch_groups(groups)
    want = np.concatenate([_jax_sample(lg, pt, rows) for lg, pt, rows in groups], axis=1)
    total = torch.zeros(want.shape, dtype=torch.int64)
    for i in range(shards):
        part = [(lg, pt, [r[i * (r.shape[0] // shards):(i + 1) * (r.shape[0] // shards)]
                          if r.shape[0] >= shards else (r if i == 0 else None) for r in rows])
                for lg, pt, rows in tg]
        got = tpoly.sample_groups(part, shard=i)
        np.testing.assert_array_equal(oods_kernels.emulate(part, shard=i, seed=i).numpy(),
                                      got.numpy())
        total += got.to(torch.int64)
    np.testing.assert_array_equal((total % P).numpy().astype(np.uint32), want)


def test_none_rows_sample_to_zero():
    groups = _torch_groups(_groups(3, [(5, 3), (7, 2)]))
    whole = tpoly.sample_groups(groups)
    holed = [(lg, pt, [None if k == 1 else r for k, r in enumerate(rows)])
             for lg, pt, rows in groups]
    got = tpoly.sample_groups(holed)
    assert not got[:, [1, 4]].any()
    keep = [0, 2, 3]
    np.testing.assert_array_equal(got[:, keep].numpy(), whole[:, keep].numpy())
    np.testing.assert_array_equal(oods_kernels.emulate(holed).numpy(), got.numpy())


def _walk_counts(lp):
    """How often the launch's walk (ops/oods_kernels.walk: a block's small
    rows, then its big rows and its pair rows a member at a time) reads each
    coefficient of each output column's row, by column."""
    counts = {}
    threads = 1 << oods_kernels.THREADS_LOG
    slot_member = lp.words[-lp.slots:] if lp.slots else np.zeros(0, np.uint32)

    def read(w, lo, hi, points=1):
        for p in range(points):
            c = counts.setdefault(int(w[5 + 2 * p]), np.zeros(1 << int(w[2]), np.int64))
            c[lo:hi] += 1

    for step in oods_kernels.walk(lp):
        if step.kind == "small":
            for slot in range(step.row * threads, min((step.row + 1) * threads, lp.slots)):
                w = lp.small[int(slot_member[slot])]
                k, n_at = slot - int(w[4]), 1 << min(int(w[2]), oods_kernels.QUAD_LOG)
                read(w, k * 4, k * 4 + n_at)
            continue
        pair = step.kind == "pair"
        w = (lp.pairs if pair else lp.big)[step.member]
        log = oods_kernels.PAIR_LOG if pair else oods_kernels.ROW_LOG
        for row in range(step.lo - int(w[4]), step.hi - int(w[4])):
            read(w, row << log, (row + 1) << log, 2 if pair else 1)  # thread t: its 4 or 2
    return counts


@pytest.mark.parametrize("blocks", [1, 3, 7, 132, 5000])
def test_schedule_covers_every_coefficient_once(blocks):
    """The walk covers every coefficient of every member exactly once:
    rows of 2^0 to 2^6, odd and even trace logs, 2^10 and longer rows, a
    group whose rows are all None, shard chunks; the spans split the
    weighted rows evenly and in order."""
    groups = _torch_groups(_groups(blocks, [(k, 2) for k in range(1, 8)] +
                                   [(9, 3), (10, 2), (11, 1), (13, 2)]))
    groups.append((5, groups[0][1], [None, None]))
    # rows at a second point: pairs (2^9 and longer) and small rows read twice
    groups += [(lg, groups[0][1], rows[:1]) for lg, _, rows in groups if lg in (6, 9, 10, 13)]
    chunked = [(lg, pt, [r[:r.shape[0] // 2] if lg > 2 else r for r in rows])
               for lg, pt, rows in groups if lg != 5]
    for gs, shard in ((groups, 0), (chunked, 1)):
        lp = oods_kernels.plan(gs, shard, blocks, cuda=False)
        assert lp.n_pairs == (3 if shard == 0 else 2)  # 2^9 halves to a small row
        counts = _walk_counts(lp)
        live = [k for k, r in enumerate(r for _, _, rows in gs for r in rows) if r is not None]
        assert sorted(counts) == live
        for c in counts.values():
            assert (c == 1).all()
        sch = oods_kernels.schedule(lp.small_rows, lp.big_rows, lp.pair_rows, blocks)
        units = (1, oods_kernels.ROW_CHUNK, oods_kernels.PAIR_CHUNK)
        counts = (lp.small_rows, lp.big_rows, lp.pair_rows)
        weights = (oods_kernels.SMALL_WEIGHT, 1, 1)
        assert sch.grid == min(blocks, sum(c // u * w for c, u, w in zip(counts, units, weights)))
        weight = 0
        for (lo, hi), c, unit, w in zip(((sch.small_lo, sch.small_hi), (sch.big_lo, sch.big_hi),
                                         (sch.pair_lo, sch.pair_hi)), counts, units, weights):
            assert (lo[1:] == hi[:-1]).all() and lo[0] == 0 and hi[-1] == c
            assert not (lo % unit).any()  # whole chunks
            weight = weight + (hi - lo) // unit * w
        assert weight.max() - weight.min() <= 2 * oods_kernels.SMALL_WEIGHT
    with pytest.raises(ValueError):
        oods_kernels.schedule(0, 0, 0, 4)
    with pytest.raises(ValueError):
        oods_kernels.schedule(1, 4, 0, 0)


def test_group_factors_match_point_factors():
    """The factors as the kernel builds them (one vectorised doubling chain
    over the groups) are poly._point_factors a group."""
    groups = _groups(11, [(k, 0) for k in (1, 2, 5, 10, 17, 30)])
    groups.append((3, ((1, 0, 0, 0), (0, 0, 0, 0)), []))
    got = oods_kernels.group_factors(groups)
    assert got.shape == (len(groups), 30, 4)
    for g, (lg, pt, _) in enumerate(groups):
        assert [tuple(int(v) for v in f) for f in got[g, :lg]] == tpoly._point_factors(lg, pt)


def test_table_layout():
    """Members (big, pairs, small: 9 words each), groups (9 words), each
    block's first big member and first pair, each slot's small member."""
    groups = _torch_groups(_groups(5, [(4, 2), (9, 1), (11, 2), (10, 1)]))
    groups.append((11, groups[2][1], [groups[2][2][1]]))  # row 4 at a second point: a pair
    lp = oods_kernels.plan(groups, 0, 3, cuda=False)
    mw = oods_kernels.MEMBER_WORDS
    assert (lp.n_big, lp.n_pairs, lp.n_small, lp.n_groups, lp.total) == (2, 1, 3, 5, 7)
    # rows padded to whole chunks: 2 and 1 big rows to 4 each; 4 pair rows
    assert (lp.big_rows, lp.pair_rows, lp.slots, lp.small_rows) == (8, 4, 128 + 4 + 4, 1)
    words = lp.words.astype(np.int64)
    members = words[:mw * 6].reshape(6, mw)
    # big: columns 3 and 5 (2^11, 2^10); the pair: column 4 with 6; small: 2^9, 2^4, 2^4
    assert [tuple(int(v) for v in m[4:]) for m in members] == [
        (0, 3, 2, 0, 0), (4, 5, 3, 0, 0), (0, 4, 2, 6, 4), (0, 2, 1, 0, 0), (128, 0, 0, 0, 0),
        (132, 1, 0, 0, 0)]
    rows = [r for _, _, rs in groups for r in rs]
    for m in members:
        row = rows[int(m[5])]
        assert (int(m[0]) | int(m[1]) << 32) == row.data_ptr()
        assert (int(m[2]), int(m[3])) == (row.shape[0].bit_length() - 1, 0)
    at = mw * 6
    for gi, (lg, pt, _) in enumerate(groups):
        assert tuple(words[at + 9 * gi:at + 9 * gi + 9]) == (lg, *pt[0], *pt[1])
    at += 9 * 5
    sch = oods_kernels.schedule(1, 8, 4, 3)
    assert lp.grid == sch.grid == 3  # weights: the small row 2, two big chunks, one pair chunk
    assert list(sch.small_hi) == [1, 1, 1] and list(sch.big_hi) == [0, 4, 8]
    assert list(sch.pair_lo) == [0, 0, 0] and list(sch.pair_hi) == [0, 0, 4]
    assert list(words[at:at + 6]) == [0, 0, 1, 0, 0, 0]  # each block's first big member, pair
    assert list(words[at + 6:]) == [0] * 128 + [1] * 4 + [2] * 4


def test_unaligned_big_rows_are_read_from_aligned_copies():
    """A row of 2^10 or more that does not start on 16 bytes (the kernel
    reads it 16 bytes a thread) is planned from an aligned copy."""
    rng = np.random.default_rng(4)
    long = torch.as_tensor(rng.integers(0, P, (1 << 11) + 4).astype(np.int32))
    pt = _point(rng)
    groups = [(11, pt, [long[1:1 + (1 << 11)], long[:1 << 11]]), (3, pt, [long[1:9]])]
    lp = oods_kernels.plan(groups, 0, 4, cuda=False)
    ptrs = [int(m[0]) | int(m[1]) << 32 for m in lp.big]
    assert lp.n_pairs == 0 and all(p % 16 == 0 for p in ptrs) and ptrs[1] == long.data_ptr()
    assert int(lp.small[0][0]) | int(lp.small[0][1]) << 32 == long.data_ptr() + 4
    want = np.concatenate([_jax_sample(lg, p, [r.numpy().astype(np.uint32) for r in rows])
                           for lg, p, rows in groups], axis=1)
    np.testing.assert_array_equal(oods_kernels.emulate(groups).numpy().astype(np.uint32), want)


def test_more_groups_than_a_launch_takes():
    """More than MAX_GROUPS groups: one launch each MAX_GROUPS, the columns
    of a launch whose rows are all None left 0."""
    spec = [(2 + k % 9, 1 + k % 3) for k in range(oods_kernels.MAX_GROUPS + 5)]
    groups = _torch_groups(_groups(2, spec))
    groups[-1] = (groups[-1][0], groups[-1][1], [None] * len(groups[-1][2]))
    assert len(oods_kernels._chunks(groups)) == 2
    got = oods_kernels.emulate(groups, seed=3)
    np.testing.assert_array_equal(got.numpy(), tpoly.sample_groups(groups).numpy())
    assert not got[:, -len(groups[-1][2]):].any()
    with pytest.raises(ValueError):
        oods_kernels.plan(groups, 0, 4, cuda=False)


@pytest.mark.parametrize("points", [1, 2, 3, 6])
def test_a_row_opened_at_several_points(points):
    """A row in several groups of one trace log (a column opened at several
    shifts) is read once for two points (a pair), the next two, ...: its
    samples at every point equal the JAX package's."""
    rng = np.random.default_rng(points)
    log_size = 10
    shared = rng.integers(0, P, (2, 1 << log_size), dtype=np.uint32)
    own = rng.integers(0, P, (points, 1 << log_size), dtype=np.uint32)
    tshared = [torch.as_tensor(r.astype(np.int32)) for r in shared]
    groups = [(log_size, _point(rng), [tshared[0], torch.as_tensor(own[k].astype(np.int32)),
                                       tshared[1]]) for k in range(points)]
    lp = oods_kernels.plan(groups, 0, 5, cuda=False)
    pairs = [(3 * k + j, k, 3 * (k + 1) + j, k + 1) for k in range(0, points - 1, 2)
             for j in (0, 2)]
    assert sorted(tuple(int(v) for v in m[5:]) for m in lp.pairs) == sorted(pairs)
    assert sorted((int(m[5]), int(m[6])) for m in lp.big) == sorted(
        [(3 * k + 1, k) for k in range(points)] +
        [(3 * (points - 1) + j, points - 1) for j in (0, 2)] * (points % 2))
    assert lp.words.size == oods_kernels.MEMBER_WORDS * (lp.n_big + lp.n_pairs) + \
        oods_kernels.GROUP_WORDS * points + 2 * lp.grid + lp.slots
    want = np.concatenate([_jax_sample(lg, pt, [shared[0], own[k], shared[1]])
                           for k, (lg, pt, _) in enumerate(groups)], axis=1)
    got = tpoly.sample_groups(groups)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(oods_kernels.emulate(groups, seed=1).numpy(), got.numpy())


class _FakeLibrary:
    """Stands in for the built library at bind time: its constants and its
    spans (the blocks' in reverse order if `reverse`)."""

    def __init__(self, constants, reverse):
        def oods_constants(addr):
            (ctypes.c_int * len(constants)).from_address(addr)[:] = constants

        def oods_schedule(b, grid, small_rows, big_rows, pair_rows, addr):
            sch = oods_kernels.schedule(small_rows, big_rows, pair_rows, grid)
            at = grid - 1 - b if reverse else b
            (ctypes.c_longlong * 6).from_address(addr)[:] = tuple(int(v[at]) for v in sch[1:])
            return 0

        self.oods_constants, self.oods_schedule = oods_constants, oods_schedule
        self.oods_sample = self.oods_max_blocks = self.oods_attributes = lambda *args: 0


@pytest.mark.parametrize("change", ["none", "member_words", "group_words", "max_log", "tile",
                                    "threads", "quad", "row", "pair", "row_chunk", "pair_chunk",
                                    "weight", "max_groups", "schedule"])
def test_bind_refuses_a_library_that_differs(change):
    """At load the library's constants (table layout, walk, grid) and its
    spans of every block of BIND_CASES must be the wrapper's copies; any
    difference raises."""
    names = {"max_log": "MAX_LOG_SIZE", "member_words": "MEMBER_WORDS",
             "group_words": "GROUP_WORDS", "threads": "THREADS_LOG", "quad": "QUAD_LOG",
             "row": "ROW_LOG", "pair": "PAIR_LOG", "tile": "TILE_ROWS",
             "row_chunk": "ROW_CHUNK", "pair_chunk": "PAIR_CHUNK", "weight": "SMALL_WEIGHT",
             "max_groups": "MAX_GROUPS"}
    assert set(names.values()) == set(oods_kernels.CONSTANTS)
    constants = list(oods_kernels._constants())
    if change in names:
        constants[oods_kernels.CONSTANTS.index(names[change])] += 1
    lib = _FakeLibrary(constants, change == "schedule")
    if change == "none":
        oods_kernels._bind(lib)
    else:
        with pytest.raises(RuntimeError, match="csrc/oods.cu"):
            oods_kernels._bind(lib)


def test_wrapper_refuses_before_loading_the_library():
    groups = _torch_groups(_groups(9, [(6, 2)]))
    lg, pt, rows = groups[0]
    kernel = oods_kernels.OodsKernel()
    with pytest.raises(ValueError, match="CUDA"):
        kernel.sample(groups)
    with pytest.raises(TypeError):
        kernel.sample([(lg, pt, [r.to(torch.int64) for r in rows])])
    with pytest.raises(ValueError):
        kernel.sample([(lg, pt, [r[:48] for r in rows])])
    with pytest.raises(ValueError):
        kernel.sample([(lg, pt, [None, None])])
    assert kernel.lib._lib is None and kernel.launches == 0


def test_plan_refuses_what_the_kernel_does_not_take():
    """Every refusal of the row checks (the CUDA check aside, as emulate
    plans CPU rows): non-tensors, other dtypes, 2-D or strided rows, a
    length that is not a power of two or exceeds 2^log_size, a chunk
    outside its row, a trace log outside 1..30, a negative shard, rows on
    two devices, too many groups for a launch."""
    groups = _torch_groups(_groups(8, [(6, 2)]))
    lg, pt, rows = groups[0]
    bad = {
        TypeError: [[(lg, pt, [rows[0].numpy()])], [(lg, pt, [rows[0].to(torch.int64)])]],
        ValueError: [[(lg, pt, [rows[0].reshape(8, 8)])], [(lg, pt, [rows[0][::2]])],
                     [(lg, pt, [rows[0][:48]])], [(lg, pt, [rows[0][:0]])],
                     [(5, pt, [rows[0]])], [(0, pt, [rows[0][:1]])], [(31, pt, [rows[0]])],
                     [(lg, pt, [None])], [(lg, pt, [rows[0][:16]])] * 65,
                     [(lg, pt, [rows[0], rows[1].to("meta")])]],
    }
    for exc, cases in bad.items():
        for gs in cases:
            with pytest.raises(exc):
                oods_kernels.plan(gs, 0, 4, cuda=False)
    with pytest.raises(ValueError):
        oods_kernels.plan([(lg, pt, [rows[0][:16]])], 4, 4, cuda=False)  # 64..80 of 64
    with pytest.raises(ValueError):
        oods_kernels.plan([(lg, pt, [rows[0][:16]])], -1, 4, cuda=False)
    lp = oods_kernels.plan([(lg, pt, [rows[0][:16]])], 3, 4, cuda=False)  # 48..64: inside
    assert int(lp.small[0][3]) == 48
