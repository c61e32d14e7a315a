"""The OODS sampling of the port against the JAX package's, bit for bit:
the vectorised half bases against stwo_brainfuck_tpu/core/poly.py:53
half_bases_at_point, and poly.sample_groups (the plain version, and the
OODS kernel's emulation, ops/oods_kernels.emulate: its tiles, each
thread's rows and column, the bases built from the factors, the blocks'
sums in a random order) against poly._sample_tensor_jit a group, whole
and as a mesh shard's chunks. The kernel's schedule and table layout, and
the wrapper's refusals (it checks before it loads the library, and at load
that the library's constants and tiles are its own)."""

import ctypes
from unittest import mock

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


def test_schedule_covers_every_coefficient_once():
    """A row's blocks tile its (H_n, L_n) matrix exactly: W x H_b positions
    a block, at most 2^TILE_LOG, H_b rows of b_hi fitting the kernel's 2^9, and
    256 threads of R = 256 / W rows each."""
    for log_size in range(1, 31):
        for log_n in range(0, log_size + 1):
            t = oods_kernels.schedule(log_size, log_n)
            assert t.lo == log_size // 2
            assert t.log_hb <= 9 and t.log_w <= 8
            assert t.log_w + t.log_hb <= oods_kernels.TILE_LOG
            assert t.blocks << (t.log_w + t.log_hb) == 1 << log_n
    with pytest.raises(ValueError):
        oods_kernels.schedule(31, 4)
    with pytest.raises(ValueError):
        oods_kernels.schedule(8, 9)


def test_table_layout():
    groups = _torch_groups(_groups(5, [(4, 2), (9, 1)]))
    mem = oods_kernels.members(groups)
    words, blocks = oods_kernels.pack(groups, mem)
    n_m, mw = len(mem), oods_kernels.MEMBER_WORDS
    assert [(m.column, m.group) for m in mem] == [(0, 0), (1, 0), (2, 1)]
    assert blocks == sum(oods_kernels.schedule(groups[m.group][0], m.log_n).blocks for m in mem)
    first = 0
    for k, m in enumerate(mem):
        w = words[mw * k:mw * (k + 1)]
        assert (int(w[0]) | int(w[1]) << 32) == m.row.data_ptr()
        assert tuple(int(v) for v in w[2:]) == (m.log_n, m.offset, first, m.column, m.group)
        first += oods_kernels.schedule(groups[m.group][0], m.log_n).blocks
    for gi, (lg, pt, _) in enumerate(groups):
        log_size, at = (int(v) for v in words[mw * n_m + 2 * gi:][:2])
        assert log_size == lg
        factors = words[at:at + 4 * lg].reshape(lg, 4)
        assert [tuple(int(v) for v in f) for f in factors] == tpoly._point_factors(lg, pt)


@pytest.mark.parametrize("points", [1, 2, 3, 6])
def test_a_row_opened_at_several_points(points):
    """A row in several groups of one trace log (a column opened at several
    shifts) is one member a point, read once a point: its samples at every
    point equal the JAX package's."""
    rng = np.random.default_rng(points)
    log_size = 10
    shared = rng.integers(0, P, (2, 1 << log_size), dtype=np.uint32)
    own = rng.integers(0, P, (points, 1 << log_size), dtype=np.uint32)
    tshared = [torch.as_tensor(r.astype(np.int32)) for r in shared]
    groups = [(log_size, _point(rng), [tshared[0], torch.as_tensor(own[k].astype(np.int32)),
                                       tshared[1]]) for k in range(points)]
    mem = oods_kernels.members(groups)
    assert [(m.column, m.group) for m in mem] == [(3 * k + j, k) for k in range(points)
                                                  for j in range(3)]
    words, _ = oods_kernels.pack(groups, mem)
    assert words.size == oods_kernels.MEMBER_WORDS * len(mem) + 2 * points + \
        4 * log_size * points
    want = np.concatenate([_jax_sample(lg, pt, [shared[0], own[k], shared[1]])
                           for k, (lg, pt, _) in enumerate(groups)], axis=1)
    got = tpoly.sample_groups(groups)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(oods_kernels.emulate(groups, seed=1).numpy(), got.numpy())


class _FakeLibrary:
    """Stands in for the built library at bind time: its constants and its
    tiles as csrc/oods.cu would give them with other constants."""

    def __init__(self, constants, tile_log):
        def oods_constants(addr):
            (ctypes.c_int * 3).from_address(addr)[:] = constants

        def oods_schedule(log_size, log_n, addr):
            with mock.patch.object(oods_kernels, "TILE_LOG", tile_log):
                tile = oods_kernels.schedule(log_size, log_n)
            (ctypes.c_longlong * 5).from_address(addr)[:] = tuple(tile)
            return 0

        self.oods_constants, self.oods_schedule = oods_constants, oods_schedule
        self.oods_sample = lambda *args: 0


@pytest.mark.parametrize("change", ["none", "member_words", "group_words", "max_log", "tile"])
def test_bind_refuses_a_library_that_differs(change):
    """At load the library's table layout and its tiles at every (log_size,
    log_n) must be the wrapper's copies; any difference raises."""
    constants = [oods_kernels.MAX_LOG_SIZE, oods_kernels.MEMBER_WORDS, oods_kernels.GROUP_WORDS]
    at = {"max_log": 0, "member_words": 1, "group_words": 2}.get(change)
    if at is not None:
        constants[at] += 1
    lib = _FakeLibrary(constants, oods_kernels.TILE_LOG - (change == "tile"))
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
