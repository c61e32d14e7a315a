"""The quotient kernel's arithmetic and the redesigned grind's search order,
held on the CPU against the JAX package and hashlib (the CUDA kernels run
only on a card: tests/test_torch_gpu.py).

- The kernel's point generation (ops/quotient_kernels.emulate_points: the
  same tables and index arithmetic) equals the domain points, and at 2^28
  the host's points at seeded positions.
- The plain version's ranges (quotients.accumulate_plain at an offset)
  concatenate to the whole and equal the JAX package's
  accumulate_quotients, for 1-3 point groups, a column sampled at two
  shifts and more columns than the JAX package's column chunk.
- The kernel's index and offset expressions, evaluated in their C types,
  do not wrap at 2^28 over 8 shards.
- The grind's tile order and early exit (blake2s_kernels.emulate_grind)
  return hashlib's smallest nonce.
- The point groups of every size from one pass (quotients.point_groups,
  one alpha ladder) equal a claim-by-claim oracle on the benchmark cells'
  layouts and at the edges (alpha 0 and 1, a group of one member, a size
  of one group); prepare_point_groups keeps its form; accumulate_quotients
  launches the largest size first with each size's output unchanged.
Tolerance: none, bit for bit."""

import hashlib
import json
import pathlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.core import quotients as jq
from stwo_brainfuck_tpu_torch import air, convert, tracing
from stwo_brainfuck_tpu_torch.core import qm31
from stwo_brainfuck_tpu_torch.core import quotients as tq
from stwo_brainfuck_tpu_torch.core.circle import point_from_t
from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig, shifted_point
from stwo_brainfuck_tpu_torch.ops import blake2s_kernels as bk
from stwo_brainfuck_tpu_torch.ops import quotient_kernels as qk

torch.set_num_threads(1)
P = 2**31 - 1


def _felt(rng):
    return tuple(int(v) for v in rng.integers(0, P, 4))


def quotient_case(seed: int, log_size: int, n_cols: int, n_groups: int):
    """Columns (n_cols, 2^log_size) and claims at n_groups points: every
    column at z, column c also at z - s g for s = c % n_groups > 0 (so
    such a column is sampled at two shifts), an alpha."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, P, (n_cols, 1 << log_size), dtype=np.uint32)
    z = point_from_t(_felt(rng))
    raw, aidx = [], 0
    for c in range(n_cols):
        cl = []
        for shift in sorted({0, c % n_groups}):
            cl.append((shifted_point(z, log_size - 1, shift), _felt(rng), aidx))
            aidx += 1
        raw.append(cl)
    return cols, raw, _felt(rng)


@pytest.mark.parametrize("log_size", range(1, 21))
def test_kernel_points_equal_the_domain(log_size):
    gx, gy = tq.domain_points_storage(log_size, "cpu")
    ex, ey = qk.emulate_points(log_size, torch.arange(1 << log_size))
    assert torch.equal(ex, gx) and torch.equal(ey, gy)


def test_kernel_points_at_2_28_equal_the_host_points():
    log = 28
    rng = np.random.default_rng(28)
    pos = np.unique(np.concatenate([[0, (1 << 27) - 1, 1 << 27, (1 << 28) - 1],
                                    rng.integers(0, 1 << log, 996)]))
    assert pos.size == 1000
    ex, ey = qk.emulate_points(log, torch.as_tensor(pos.astype(np.int64)))
    hx, hy = tq.points_at_storage_batch(log, pos)
    np.testing.assert_array_equal(ex.numpy(), hx.astype(np.int64))
    np.testing.assert_array_equal(ey.numpy(), hy.astype(np.int64))
    # the plain version's range points too
    rx, ry = tq.points_storage_range(log, (1 << 27) - 2, 4, "cpu")
    hx, hy = tq.points_at_storage_batch(log, np.arange((1 << 27) - 2, (1 << 27) + 2))
    np.testing.assert_array_equal(rx.numpy(), hx.astype(np.int64))
    np.testing.assert_array_equal(ry.numpy(), hy.astype(np.int64))


@pytest.mark.parametrize("log_size, n_cols, n_groups, chunk_log", [
    (5, 4, 1, 3), (7, 9, 2, 5), (9, 70, 3, 6), (12, 5, 3, 10), (10, 70, 1, 7)])
def test_plain_ranges_equal_the_whole_and_jax(log_size, n_cols, n_groups, chunk_log):
    cols, raw, alpha = quotient_case(log_size + n_cols, log_size, n_cols, n_groups)
    want = np.asarray(jq.accumulate_quotients(
        log_size, [jnp.asarray(c) for c in cols],
        [[jq.QuotientClaim(p, v, a) for p, v, a in cl] for cl in raw], alpha))
    claims = [[tq.QuotientClaim(p, v, a) for p, v, a in cl] for cl in raw]
    whole = tq.accumulate_quotients({log_size: ([convert.to_torch(c) for c in cols], claims)},
                                    alpha)[log_size]
    np.testing.assert_array_equal(convert.to_numpy(whole), want)
    groups = tq.point_groups({log_size: claims}, alpha)[log_size]
    assert len(groups) == n_groups
    tcols = torch.as_tensor(cols.view(np.int32))
    step = 1 << chunk_log
    for fn in (tq.accumulate_plain, tq.accumulate_range):
        parts = [fn(log_size, [c[s:s + step] for c in tcols], groups, s)
                 for s in range(0, 1 << log_size, step)]
        np.testing.assert_array_equal(torch.cat(parts, 1).numpy().view(np.uint32), want)
    # an odd range
    off, n = 3, (1 << log_size) - 5
    got = tq.accumulate_plain(log_size, [c[off:off + n] for c in tcols], groups, off)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want[:, off:off + n])


def test_pack_groups_layout():
    cols, raw, alpha = quotient_case(1, 6, 5, 2)
    claims = [[tq.QuotientClaim(p, v, a) for p, v, a in cl] for cl in raw]
    groups = tq.point_groups({6: claims}, alpha)[6]
    words = qk.pack_groups(groups)
    at = 0
    for consts, weights, idxs in groups:
        assert words[at] == len(idxs)
        np.testing.assert_array_equal(words[at + 1:at + qk.HEADER_WORDS], consts.reshape(-1))
        at += qk.HEADER_WORDS
        for ci, w in zip(idxs, weights):
            assert words[at] == ci
            np.testing.assert_array_equal(words[at + 1:at + qk.MEMBER_WORDS], w)
            at += qk.MEMBER_WORDS
    assert at == words.size


def test_kernel_wrapper_refuses_the_cpu():
    cols, raw, alpha = quotient_case(2, 5, 2, 1)
    claims = [[tq.QuotientClaim(p, v, a) for p, v, a in cl] for cl in raw]
    groups = tq.point_groups({5: claims}, alpha)[5]
    with pytest.raises(ValueError):
        qk.KERNEL.accumulate(5, [torch.as_tensor(c.view(np.int32)) for c in cols], groups)
    with pytest.raises(TypeError):
        qk.KERNEL.accumulate(5, [torch.as_tensor(c.astype(np.int64)) for c in cols], groups)
    assert qk.KERNEL.launches == 0


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
def test_kernel_offsets_at_2_28_do_not_wrap(shards):
    """csrc/quotients.cu at log_size 28 (the production composition) over
    `shards` chunks: for each shard's first and last thread, the uint32
    expressions of quotients_kernel and domain_point, the table indices,
    the output words, and the grid."""
    log, threads = 28, 256
    n = (1 << log) // shards
    assert qk.MAX_LOG_SIZE - log >= 0
    for shard in range(shards):
        offset = shard * n
        blocks = U32(-(-n // threads), "blocks")
        assert blocks <= 2**31 - 1
        for t in (0, n - 1):
            bid, tid = divmod(t, threads)
            t32 = U32(U32(bid * threads, "blockIdx.x * kThreads") + tid, "t")
            i = U32(offset + t32, "a.offset + t")
            assert i < 1 << log
            r = int(f"{i:032b}"[::-1], 2) >> (32 - log)
            half = U32(1 << (log - 1), "half")
            j = r if r < half else r - half
            k = U32(U32(U32(4 * j, "4u * j") + 1, "1u + 4u * j") << (qk.MAX_LOG_SIZE - log), "k")
            assert k < 1 << 31
            assert (k & ((1 << qk.LO_LOG) - 1)) < 1 << qk.LO_LOG
            assert k >> qk.LO_LOG < 1 << qk.HI_LOG
            U32(n + t32, "a.n + t")
            assert U64(3 * n + t32, "3ull * a.n + t") < 4 * n
    # the largest k over the whole domain
    j_max = (1 << (log - 1)) - 1
    assert U32((1 + 4 * j_max) << (qk.MAX_LOG_SIZE - log), "k") < 1 << 31


def test_grind_order_covers_each_tile_once_in_waves():
    ctas, span, tile = 6, 1000, 16
    order = bk.grind_order(ctas, span, tile)
    starts = sorted(s for q in order for s in q)
    assert starts == list(range(0, span, tile))
    for c, q in enumerate(order):
        assert q == sorted(q) and q[0] == c * tile
        assert all(b - a == ctas * tile for a, b in zip(q, q[1:]))
    assert bk.GRIND_SPAN < 1 << 32 and bk.GRIND_SPAN == bk._NO_HIT


def _hashlib_grind(digest: bytes, pow_bits: int) -> int:
    nonce = 0
    while int.from_bytes(hashlib.blake2s(digest + struct.pack("<Q", nonce)).digest()[:4],
                         "little") & ((1 << pow_bits) - 1):
        nonce += 1
    return nonce


@pytest.mark.parametrize("case", range(30))
def test_emulated_grind_finds_the_smallest_nonce(case):
    rng = np.random.default_rng(100 + case)
    digest = rng.integers(0, 256, 32).astype(np.uint8).tobytes()
    bits = 4 + case % 9
    # the card's grid (132 SMs x 4 CTAs of 256 threads), or a small one
    ctas, tile = (bk.H100_SMS * bk.GRIND_CTAS_A_SM, bk.GRIND_TILE) if case % 3 == 0 else (7, 32)
    want = _hashlib_grind(digest, bits)
    got, hashed = bk.emulate_grind(digest, bits, ctas, tile, seed=case)
    assert got == want
    assert want + 1 <= hashed < 1 << 20


def _groups(cols, raw, alpha):
    claims = [[tq.QuotientClaim(p, v, a) for p, v, a in cl] for cl in raw]
    return tq.point_groups({0: claims}, alpha)[0]


def _zero_line(groups):
    """The first group with dy = dx = vc = 0: its vanishing value is 0 at
    every position, so every batch meets zero norms."""
    consts = groups[0][0].copy()
    consts[2:] = 0
    return [(consts, *groups[0][1:])] + list(groups[1:])


# (log_size, n_cols, n_groups, offset, n): walks at K = 8 and 4, lookups with
# tails (n not a multiple of K or of a CTA's 256 threads), the first size
# that walks, and 2-, 4- and 8-shard chunks
SCHEDULE_CASES = [(10, 4, 1, 0, 1 << 10), (10, 5, 2, 0, 1 << 10), (9, 3, 3, 0, 1 << 9),
                  (9, 3, 1, 5, 100), (9, 2, 2, 7, 301), (8, 2, 1, 0, 1 << 8),
                  (8, 2, 1, 0, 1 << 7), (7, 2, 2, 0, 1 << 7), (6, 3, 3, 1, 7)] + [
                  (12, 4, g, i << (12 - d), 1 << (12 - d)) for d, i, g in
                  ((1, 1, 1), (2, 3, 2), (3, 5, 1), (3, 7, 3))]


@pytest.mark.parametrize("log_size, n_cols, n_groups, offset, n", SCHEDULE_CASES)
def test_kernel_schedule_emulation_equals_plain_and_jax(log_size, n_cols, n_groups, offset, n):
    cols, raw, alpha = quotient_case(log_size * 7 + offset, log_size, n_cols, n_groups)
    want = np.asarray(jq.accumulate_quotients(
        log_size, [jnp.asarray(c) for c in cols],
        [[jq.QuotientClaim(p, v, a) for p, v, a in cl] for cl in raw], alpha))
    groups = _groups(cols, raw, alpha)
    part = [c[offset:offset + n] for c in torch.as_tensor(cols.view(np.int32))]
    got = qk.emulate(log_size, part, groups, offset)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want[:, offset:offset + n])
    zero = _zero_line(groups)
    assert torch.equal(qk.emulate(log_size, part, zero, offset),
                       tq.accumulate_plain(log_size, part, zero, offset))


def test_schedule_walks_whole_domains_and_shard_chunks_only():
    assert qk.schedule(1, 0, 1 << 28) == (8, True, 1 << 25)
    assert qk.schedule(2, 0, 1 << 21) == (4, True, 1 << 19)
    assert qk.schedule(1, 3 << 20, 1 << 20) == (8, True, 1 << 17)
    assert qk.schedule(1, 0, 1 << 7) == (8, False, 16)      # below 2^(3 + 5)
    assert qk.schedule(2, 0, 1 << 7) == (4, True, 32)
    assert qk.schedule(1, 1 << 10, 1 << 11) == (8, False, 256)  # offset not a multiple of n
    assert qk.schedule(3, 0, 1000) == (4, False, 250)
    assert qk.schedule(1, 5, 100) == (8, False, 13)


@pytest.mark.parametrize("log_size, offset, n", [(10, 0, 1 << 10), (20, 0, 1 << 12),
                                                 (28, 5 << 12, 1 << 12),
                                                 (28, (1 << 28) - (1 << 9), 1 << 9)])
def test_walked_points_are_the_domain_points(log_size, offset, n):
    k, walk, stride = qk.schedule(1, offset, n)
    assert walk
    px, py = qk._walk_points(log_size, offset, n, k, stride, "cpu")
    idx = torch.tensor([qk._rev(m, 3) for m in range(k)])
    pos = offset + torch.arange(stride)[:, None] + idx[None, :] * stride
    ex, ey = qk.emulate_points(log_size, pos.reshape(-1))
    assert torch.equal(px.reshape(-1), ex) and torch.equal(py.reshape(-1), ey)


def test_batched_inverse_keeps_zero_at_zero():
    rng = np.random.default_rng(5)
    z = torch.as_tensor(rng.integers(0, P, (64, 8)))
    z[rng.random((64, 8)) < 0.2] = 0
    z[0] = 0
    want = torch.where(z == 0, 0, torch.as_tensor([[pow(int(v), P - 2, P) for v in row]
                                                   for row in z.tolist()]))
    assert torch.equal(qk.batch_inv(z), want)


def naive_groups(claims, alpha):
    """One size's point groups claim by claim, the oracle of
    quotients.point_groups: a group a point in order of first appearance,
    its members in claim order, alpha^k by h_pow a claim, dy, dx, vc and
    the line coefficients from the host QM31 functions, a group at a time.
    [((A, B, dy, dx, vc), [w], idxs)] in host QM31 tuples."""
    by_point = {}
    for ci, col in enumerate(claims):
        for c in col:
            by_point.setdefault((tuple(c.point[0]), tuple(c.point[1])), []).append((ci, c))
    out = []
    for members in by_point.values():
        zx, zy = members[0][1].point
        dy = qm31.h_sub(qm31.h_frobenius(zy), zy)
        dx = qm31.h_sub(qm31.h_frobenius(zx), zx)
        vc = qm31.h_sub(qm31.h_mul(zy, dx), qm31.h_mul(zx, dy))
        a = b = qm31.ZERO
        weights = []
        for _ci, c in members:
            w = qm31.h_pow(alpha, c.alpha_index)
            slope = qm31.h_mul(qm31.h_sub(qm31.h_frobenius(c.value), c.value), qm31.h_inv(dy))
            a = qm31.h_add(a, qm31.h_mul(w, qm31.h_sub(c.value, qm31.h_mul(zy, slope))))
            b = qm31.h_add(b, qm31.h_mul(w, slope))
            weights.append(w)
        out.append(((a, b, dy, dx, vc), weights, tuple(ci for ci, _c in members)))
    return out


def assert_groups_equal(got, want):
    """point_groups' groups of one size equal the oracle's, word for word."""
    assert len(got) == len(want)
    for (consts, weights, idxs), (w_consts, w_weights, w_idxs) in zip(got, want):
        assert consts.dtype == weights.dtype == np.uint32
        assert consts.shape == (5, 4) and weights.shape == (len(w_idxs), 4)
        assert consts.tolist() == [list(c) for c in w_consts]
        assert weights.tolist() == [list(w) for w in w_weights]
        assert idxs == w_idxs


CELLS = ["production.fib19_io", "default.big22", "default.fib19_io"]
# each cell's claims a prove, and its commitment sizes
CELL_CLAIMS = {"production.fib19_io": (303, 8), "default.big22": (301, 6),
               "default.fib19_io": (303, 8)}


def cell_claims(cell: str, seed: int):
    """A prove's quotient claims at the benchmark cell's layout (its
    workload's table sizes and its configuration), as air.prove_brainfuck
    makes them: size -> one claim list a column, the columns in tree
    order, every column sampled at its shifts of a random z, random
    values; and a random alpha."""
    root = pathlib.Path(__file__).resolve().parent.parent / "benchmark"
    work = json.loads((root / "workloads" / f"{cell}.json").read_text())
    conf = json.loads((root / "configs" / f"{work['config']}.json").read_text())
    config = PcsConfig(log_blowup=conf["log_blowup"], n_queries=conf["n_queries"],
                       pow_bits=conf["pow_bits"], log_max_rows=conf["log_max_rows"])
    layout = air.build_layout(next(iter(work["claims"].values())), config)
    rng = np.random.default_rng(seed)
    z = point_from_t(_felt(rng))
    by_size, aidx = {}, 0
    for metas in layout.trees:
        for meta in metas:
            if meta.shifts:
                by_size.setdefault(meta.log_size + config.log_blowup, []).append(
                    [tq.QuotientClaim(shifted_point(z, meta.log_size, s), _felt(rng), aidx + k)
                     for k, s in enumerate(meta.shifts)])
                aidx += len(meta.shifts)
    return by_size, _felt(rng)


@pytest.mark.parametrize("cell", CELLS)
def test_point_groups_equal_the_claim_by_claim_oracle_on_the_cells_layouts(cell):
    by_size, alpha = cell_claims(cell, CELLS.index(cell))
    n_claims, n_sizes = CELL_CLAIMS[cell]
    assert sum(len(cl) for cols in by_size.values() for cl in cols) == n_claims
    assert len(by_size) == n_sizes
    with tracing.record(0) as rec:
        got = tq.point_groups(by_size, alpha)
    assert rec.counters == {"quotients.powers": n_claims}  # one ladder a prove
    assert list(got) == list(by_size)
    for size, claims in by_size.items():
        assert_groups_equal(got[size], naive_groups(claims, alpha))


@pytest.mark.parametrize("case", ["production_size", "three_groups"])
def test_prepare_point_groups_returns_what_it_returned_before(case):
    if case == "production_size":
        by_size, alpha = cell_claims("production.fib19_io", 5)
        claims = by_size[max(by_size) - 4]  # the memory's size: two points
    else:
        _, raw, alpha = quotient_case(11, 7, 9, 3)
        claims = [[tq.QuotientClaim(p, v, a) for p, v, a in cl] for cl in raw]
    want = [(consts, list(zip(idxs, weights))) for consts, weights, idxs in
            naive_groups(claims, alpha)]
    assert tq.prepare_point_groups(claims, alpha) == want


def _one_member_size():
    rng = np.random.default_rng(3)
    z = point_from_t(_felt(rng))
    return {9: [[tq.QuotientClaim(shifted_point(z, 8, 1), _felt(rng), 4)]]}, _felt(rng)


def _sizes_of_one_and_three_groups(alpha):
    _, raw, _ = quotient_case(21, 6, 7, 3)
    _, raw1, _ = quotient_case(22, 8, 3, 1)
    offset = sum(len(cl) for cl in raw)
    return {6: [[tq.QuotientClaim(p, v, a) for p, v, a in cl] for cl in raw],
            8: [[tq.QuotientClaim(p, v, a + offset) for p, v, a in cl] for cl in raw1]}, alpha


EDGE_CASES = {
    "alpha_0": lambda: _sizes_of_one_and_three_groups((0, 0, 0, 0)),
    "alpha_1": lambda: _sizes_of_one_and_three_groups((1, 0, 0, 0)),
    "a_group_of_one_member": _one_member_size,
    "a_size_with_one_group": lambda: _sizes_of_one_and_three_groups((5, 6, 7, 8)),
}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_point_groups_edge_cases_equal_the_oracle(case):
    by_size, alpha = EDGE_CASES[case]()
    got = tq.point_groups(by_size, alpha)
    for size, claims in by_size.items():
        assert_groups_equal(got[size], naive_groups(claims, alpha))
    if case == "a_group_of_one_member":
        assert [len(g[2]) for g in got[9]] == [1]
    if case == "a_size_with_one_group":
        assert [len(got[6]), len(got[8])] == [3, 1]


def test_accumulate_quotients_launches_the_largest_size_first(monkeypatch):
    """Every size's output equals a launch of that size alone with the
    oracle's groups; the sizes go out largest first, whatever their order
    in the input."""
    sizes = [5, 8, 6]
    inputs, offset = {}, 0
    for k, log_size in enumerate(sizes):
        cols, raw, alpha = quotient_case(40 + k, log_size, 3 + k, 1 + k)
        inputs[log_size] = ([torch.as_tensor(c.view(np.int32)) for c in cols],
                            [[tq.QuotientClaim(p, v, a + offset) for p, v, a in cl] for cl in raw])
        offset += sum(len(cl) for cl in raw)
    launched = []
    plain = tq.accumulate_range
    monkeypatch.setattr(tq, "accumulate_range",
                        lambda log_size, *a: launched.append(log_size) or plain(log_size, *a))
    got = tq.accumulate_quotients(inputs, alpha)
    assert launched == sorted(sizes, reverse=True)
    for log_size, (cols, claims) in inputs.items():
        groups = [(np.array(c, np.uint32), np.array(w, np.uint32), i)
                  for c, w, i in naive_groups(claims, alpha)]
        assert torch.equal(got[log_size], tq.accumulate_plain(log_size, cols, groups))


@pytest.mark.parametrize("seed, n_cols, n_groups", [(0, 5, 1), (1, 9, 2), (2, 30, 3)])
def test_accumulate_quotients_ladder_gives_the_same_constants(seed, n_cols, n_groups):
    """The one ladder (quotients.alpha_ladder) is h_pow a power, and the
    constants made with it are the oracle's."""
    _, raw, alpha = quotient_case(seed, 8, n_cols, n_groups)
    claims = [[tq.QuotientClaim(p, v, a) for p, v, a in cl] for cl in raw]
    n = sum(len(cl) for cl in raw)
    ladder = tq.alpha_ladder(alpha, n)
    assert ladder.shape == (4, n)
    assert [tuple(ladder[:, k].tolist()) for k in range(n)] == [qm31.h_pow(alpha, k)
                                                                for k in range(n)]
    assert_groups_equal(tq.point_groups({8: claims}, alpha)[8], naive_groups(claims, alpha))
