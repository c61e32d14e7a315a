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
Tolerance: none, bit for bit."""

import hashlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.core import quotients as jq
from stwo_brainfuck_tpu_torch import convert
from stwo_brainfuck_tpu_torch.core import quotients as tq
from stwo_brainfuck_tpu_torch.core.circle import point_from_t
from stwo_brainfuck_tpu_torch.core.pcs import shifted_point
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
    whole = tq.accumulate_quotients(log_size, [convert.to_torch(c) for c in cols], claims, alpha)
    np.testing.assert_array_equal(convert.to_numpy(whole), want)
    groups = [tq._group_constants(m, alpha) for m in tq._group_claims(claims).values()]
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
    groups = [tq._group_constants(m, alpha) for m in tq._group_claims(claims).values()]
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
    groups = [tq._group_constants(m, alpha) for m in tq._group_claims(claims).values()]
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
