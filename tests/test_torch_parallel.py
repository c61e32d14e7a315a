"""The port's mesh prover pieces vs the JAX package's mesh functions (on its
8 virtual CPU devices) and vs the port's one-device functions: the mesh's
collectives and sharded-array type, the sharded circle FFT (its local
stages also through the CPU replay of the kernel with each shard's twiddle
table), the sharded Merkle commitment, one component's row-sharded prove
step, and the ShardedOps primitives. Inputs are made with numpy from a
seed; all arithmetic is integer mod p, so every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.components import defs as jdefs
from stwo_brainfuck_tpu.components import tables as jtables
from stwo_brainfuck_tpu.core import fft as jfft
from stwo_brainfuck_tpu.framework.component import LookupElements as JLookupElements
from stwo_brainfuck_tpu.parallel import fft_sharded as jfft_sharded
from stwo_brainfuck_tpu.parallel import merkle_sharded as jmerkle_sharded
from stwo_brainfuck_tpu.parallel import sharded as jsharded
from stwo_brainfuck_tpu.parallel.mesh import make_mesh as jmake_mesh
from stwo_brainfuck_tpu.vm.compiler import compile_program
from stwo_brainfuck_tpu.vm.machine import create_test_machine
from stwo_brainfuck_tpu_torch import convert
from stwo_brainfuck_tpu_torch.components import defs as tdefs
from stwo_brainfuck_tpu_torch.core import fft as tfft
from stwo_brainfuck_tpu_torch.core import fri as tfri
from stwo_brainfuck_tpu_torch.core import merkle as tmerkle
from stwo_brainfuck_tpu_torch.core import poly as tpoly
from stwo_brainfuck_tpu_torch.core import qm31 as tqm31
from stwo_brainfuck_tpu_torch.framework.component import LookupElements as TLookupElements
from stwo_brainfuck_tpu_torch.ops import circle_fft
from stwo_brainfuck_tpu_torch.parallel import fft_sharded, merkle_sharded, sharded
from stwo_brainfuck_tpu_torch.parallel.mesh import Sharded, make_mesh
from stwo_brainfuck_tpu_torch.parallel.prove import ShardedOps

torch.set_num_threads(1)
P = 2**31 - 1
T_CLASSES = {c.name: c for c in tdefs.COMPONENT_CLASSES}


def _vals(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint32)


def _np(x):
    """A tensor or a Sharded array as uint32 numpy."""
    return convert.to_numpy(x.full() if isinstance(x, Sharded) else x)


# ---------------------------------------------------------------------------
# The mesh, its collectives and the sharded-array type
# ---------------------------------------------------------------------------

def test_make_mesh_shards_round_robin_and_refuses_bad_sizes():
    mesh = make_mesh(8, "cpu")
    assert mesh.size == 8 and mesh.split_log == 3
    assert set(mesh.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError):
        make_mesh(3, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2, "cuda")


@pytest.mark.parametrize("d", [1, 2, 8])
def test_collectives_match_numpy(d):
    mesh = make_mesh(d, "cpu")
    x = _vals(d, (3, 64)).astype(np.int64)
    sh = mesh.shard(torch.as_tensor(x))
    c = 64 // d
    assert sh.chunk == c and sh.shape == (3, 64)
    chunks = [x[:, i * c:(i + 1) * c] for i in range(d)]
    for dist in [1 << k for k in range(mesh.split_log)]:
        got = mesh.exchange(sh.shards, dist)
        for i in range(d):
            np.testing.assert_array_equal(got[i].numpy(), chunks[i ^ dist])
    for i, last in enumerate(mesh.shift(sh.shards)):
        np.testing.assert_array_equal(last.numpy(), chunks[i - 1][:, -1:])
    gathered = mesh.all_gather([s[:, 0] for s in sh.shards])
    for g in gathered:
        np.testing.assert_array_equal(g.numpy(), np.stack([ch[:, 0] for ch in chunks]))
    perm = np.random.default_rng(5).permutation(64)
    got = np.concatenate([s.numpy() for s in mesh.permute(sh.shards, torch.as_tensor(perm))],
                         axis=1)
    np.testing.assert_array_equal(got, x[:, perm])
    # the input's shards are untouched by every collective
    np.testing.assert_array_equal(sh.full().numpy(), x)


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_array_reads_and_padding(d):
    mesh = make_mesh(d, "cpu")
    x = _vals(10 + d, (2, 32)).astype(np.int64)
    sh = mesh.shard(torch.as_tensor(x))
    np.testing.assert_array_equal(sh.rows(1).full().numpy(), x[1])
    pos = [31, 0, 17, 5, 16]
    np.testing.assert_array_equal(sh.gather(pos).numpy(), x[:, pos])
    np.testing.assert_array_equal(tmerkle.gather_columns(sh, pos), x[:, pos])
    for src in (sh, torch.as_tensor(x)):
        padded = mesh.pad(src, 7)
        want = np.zeros((2, 128), np.int64)
        want[:, :32] = x
        np.testing.assert_array_equal(padded.full().numpy(), want)
    stacked = mesh.stack([sh.rows(0), torch.as_tensor(x[1])])
    np.testing.assert_array_equal(stacked.full().numpy(), x)


# ---------------------------------------------------------------------------
# Sharded circle FFT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("log_size", [6, 10])
@pytest.mark.parametrize("d", [2, 8])
def test_sharded_fft_matches_jax_mesh_and_one_device(d, log_size, batched):
    shape = (3, 1 << log_size) if batched else (1 << log_size,)
    coeffs = _vals(100 + log_size + d, shape)
    jmesh = jmake_mesh(d)
    want_eval = np.asarray(jfft_sharded.make_sharded_evaluate(jmesh, log_size, batched)(
        jnp.asarray(coeffs)))
    want_coeffs = np.asarray(jfft_sharded.make_sharded_interpolate(jmesh, log_size, batched)(
        jnp.asarray(want_eval)))
    np.testing.assert_array_equal(want_coeffs, coeffs)

    mesh = make_mesh(d, "cpu")
    got_eval = fft_sharded.make_sharded_evaluate(mesh, log_size)(convert.to_torch(coeffs))
    np.testing.assert_array_equal(_np(got_eval), want_eval)
    np.testing.assert_array_equal(_np(tfft.evaluate(convert.to_torch(coeffs), log_size)),
                                  want_eval)
    got_coeffs = fft_sharded.make_sharded_interpolate(mesh, log_size)(got_eval)
    np.testing.assert_array_equal(_np(got_coeffs), coeffs)
    np.testing.assert_array_equal(
        _np(tfft.interpolate(convert.to_torch(want_eval), log_size)), coeffs)


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_extend_matches_one_device(d):
    vals = convert.to_torch(_vals(7 + d, (2, 1 << 8)))
    mesh = make_mesh(d, "cpu")
    for blowup in (1, 2):
        coeffs, ext = fft_sharded.sharded_extend(mesh, vals, 8, blowup)
        want_c, want_e = tfft.extend_with_coeffs(vals, 8, blowup)
        np.testing.assert_array_equal(_np(coeffs), _np(want_c))
        np.testing.assert_array_equal(_np(ext), _np(want_e))


@pytest.mark.parametrize("d", [2, 8])
def test_shard_tables_are_slices_of_the_global_stages(d):
    n = 9
    local = n - (d.bit_length() - 1)
    for inverse in (False, True):
        full = tfft.get_twiddles(n, inverse, "cpu")
        for i in range(d):
            stages = tfft.shard_stages(n, d, i, inverse, "cpu")
            assert [s.numel() for s in stages] == [1 << (local - 1 - L) for L in range(local)]
            table = circle_fft.shard_twiddle_table(n, d, i, inverse, "cpu")
            doubled = (2 * torch.cat(stages)) & 0xFFFFFFFF
            np.testing.assert_array_equal(table.to(torch.int64).numpy() & 0xFFFFFFFF,
                                          doubled.numpy())
            for L in range(local):
                np.testing.assert_array_equal(
                    stages[L].numpy(),
                    full[L][i << (local - 1 - L):(i + 1) << (local - 1 - L)].numpy())
    for L in range(n):
        for t in sorted({0, 1, (1 << (n - 1 - L)) - 1} & set(range(1 << (n - 1 - L)))):
            assert tfft.twiddle_at(n, L, t) == int(tfft.get_twiddles(n, False, "cpu")[L][t])


def _emulated(inverse):
    """shard_evaluate / shard_interpolate with the kernel's launches
    replayed on the CPU (circle_fft.emulate) with the shard's table."""
    def run(x, n, n_shards, i):
        local = n - (n_shards.bit_length() - 1)
        table = circle_fft.shard_twiddle_table(n, n_shards, i, inverse, "cpu")
        return circle_fft.emulate(x, local, inverse, twiddles=table,
                                  scale=1 if inverse else None)
    return run


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_fft_local_stages_through_the_kernel_replay(d, monkeypatch):
    """The counterpart of the JAX package's Pallas local stages: every
    shard's 2^11 local transform through the replay of the kernel's
    launches with the shard's twiddle table, equal to the plain version
    with the shard's stages, and the whole sharded transform equal to the
    one-device transforms of both packages."""
    log_size = 11 + (d.bit_length() - 1)
    coeffs = _vals(29, (2, 1 << log_size))
    x = convert.to_torch(coeffs)
    mesh = make_mesh(d, "cpu")
    chunk = mesh.shard(x).shards[d - 1]
    local = log_size - mesh.split_log
    np.testing.assert_array_equal(
        _np(_emulated(False)(chunk, log_size, d, d - 1)),
        _np(tfft.evaluate_plain(chunk, local, tfft.shard_stages(log_size, d, d - 1, False, "cpu"))))
    np.testing.assert_array_equal(
        _np(_emulated(True)(chunk, log_size, d, d - 1)),
        _np(tfft.interpolate_plain(chunk, local,
                                   tfft.shard_stages(log_size, d, d - 1, True, "cpu"), scale=1)))

    monkeypatch.setattr(circle_fft, "shard_evaluate", _emulated(False))
    monkeypatch.setattr(circle_fft, "shard_interpolate", _emulated(True))
    fft_sharded.make_sharded_evaluate.cache_clear()
    fft_sharded.make_sharded_interpolate.cache_clear()
    try:
        got = fft_sharded.make_sharded_evaluate(mesh, log_size)(x)
        want = np.stack([np.asarray(jfft.evaluate(jnp.asarray(r), log_size)) for r in coeffs])
        np.testing.assert_array_equal(_np(got), want)
        np.testing.assert_array_equal(_np(tfft.evaluate(x, log_size)), want)
        back = fft_sharded.make_sharded_interpolate(mesh, log_size)(got)
        np.testing.assert_array_equal(_np(back), coeffs)
    finally:
        fft_sharded.make_sharded_evaluate.cache_clear()
        fft_sharded.make_sharded_interpolate.cache_clear()


# ---------------------------------------------------------------------------
# Sharded Merkle commitment
# ---------------------------------------------------------------------------

def _merkle_columns(seed):
    rng = np.random.default_rng(seed)
    return {
        9: [rng.integers(0, P, 512, dtype=np.uint32) for _ in range(3)],
        7: [rng.integers(0, P, 128, dtype=np.uint32) for _ in range(2)],
        2: [rng.integers(0, P, 4, dtype=np.uint32)],  # a level below the split at D = 8
    }


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_merkle_root_matches_jax_and_one_device(d):
    cols = _merkle_columns(17)
    want = jmerkle_sharded.sharded_commit(jmake_mesh(d), cols)
    mesh = make_mesh(d, "cpu")
    t_cols = {k: [convert.to_torch(c) for c in v] for k, v in cols.items()}
    assert merkle_sharded.sharded_commit(mesh, t_cols) == want
    single = tmerkle.commit({k: torch.stack(v) for k, v in t_cols.items()})
    assert single.root == want
    tree = merkle_sharded.commit_sharded(mesh, t_cols)
    for k, layer in single.layers.items():
        np.testing.assert_array_equal(_np(tree.layers[k]), _np(layer))
    # the decommitment reads the sharded layers and columns through gather
    queries = [0, 5, 300, 511, 17]
    dec = tmerkle.decommit(tree, queries)
    assert dec.to_json() == tmerkle.decommit(single, queries).to_json()
    tmerkle.verify(tree.root, {9: 3, 7: 2, 2: 1}, queries, dec)


# ---------------------------------------------------------------------------
# One component's row-sharded prove step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tabs():
    m = create_test_machine(compile_program("+++>,<[>+.<-]"), b"\x01")
    m.execute()
    return jtables.all_tables(m.trace(), m.program())


def _elements():
    return ({k: JLookupElements.dummy(v) for k, v in jdefs.ELEMENT_SIZES.items()},
            {k: TLookupElements.dummy(v) for k, v in jdefs.ELEMENT_SIZES.items()})


def _jax_step(jmesh, cls, cols, log_size, jels):
    perm = jfft.coset_order_permutation(log_size)
    fn, _ = jsharded.sharded_prove_step(jmesh, cls, log_size)
    main_lin = {k: jnp.asarray(np.asarray(v)[perm]) for k, v in cols.items()}
    els_dev = {k: {kk: jnp.asarray(vv) for kk, vv in e.device().items()}
               for k, e in jels.items()}
    is_first = jnp.zeros(1 << log_size, jnp.uint32).at[0].set(1)
    return fn(main_lin, els_dev, is_first)


def _port_step(mesh, cls, cols, log_size, tels):
    perm = tfft.coset_order_permutation(log_size, "cpu")
    fn, comp = sharded.sharded_prove_step(mesh, T_CLASSES[cls.name], log_size)
    main_lin = {k: convert.to_torch(np.asarray(v))[perm] for k, v in cols.items()}
    is_first = torch.zeros(1 << log_size, dtype=torch.int64)
    is_first[0] = 1
    return fn(main_lin, tels, is_first)


@pytest.mark.parametrize("d", [1, 2, 8])
@pytest.mark.parametrize("cls", [jdefs.MemoryComponent, jdefs.ProcessorComponent])
def test_sharded_prove_step_matches_jax(tabs, cls, d):
    assert len(jax.devices()) >= d
    cols = tabs[cls.name]
    log_size = int(np.log2(len(next(iter(cols.values())))))
    jels, tels = _elements()
    s_j, claimed_j, cons_j = _jax_step(jmake_mesh(d), cls, cols, log_size, jels)
    s_t, claimed_t, cons_t = _port_step(make_mesh(d, "cpu"), cls, cols, log_size, tels)
    assert claimed_t == tuple(int(v) for v in np.asarray(claimed_j))
    np.testing.assert_array_equal(_np(s_t), np.asarray(s_j))
    assert cons_t.shape[:2] == np.asarray(cons_j).shape[:2]
    assert not _np(cons_t).any() and not np.asarray(cons_j).any()


def test_all_components_shard_and_their_sums_cancel(tabs):
    _, tels = _elements()
    mesh = make_mesh(4, "cpu")
    total = tqm31.ZERO
    for cls in jdefs.COMPONENT_CLASSES:
        cols = tabs[cls.name]
        log_size = int(np.log2(len(next(iter(cols.values())))))
        _, claimed, cons = _port_step(mesh, cls, cols, log_size, tels)
        assert not _np(cons).any(), cls.name
        total = tqm31.h_add(total, claimed)
    assert total == tqm31.ZERO


# ---------------------------------------------------------------------------
# ShardedOps primitives against the one-device functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 8])
def test_sharded_ops_sample_and_folds_match_one_device(d):
    ops = ShardedOps(make_mesh(d, "cpu"))
    log_size = 8
    rows = [convert.to_torch(_vals(40 + k, 1 << log_size)) for k in range(3)]
    b_lo, b_hi = tpoly.half_bases_at_point(log_size, ((1, 2, 3, 4), (5, 6, 7, 8)))
    want = tpoly.sample_tensor(rows, b_lo, b_hi)
    mixed = [ops.mesh.shard(rows[0]), rows[1], ops.mesh.shard(rows[2])]
    np.testing.assert_array_equal(ops.sample_tensor(mixed, b_lo, b_hi).numpy(), want.numpy())

    vals = convert.to_torch(_vals(50, (4, 1 << 9)))
    itw = tfri._fold_itw("c", 9, "cpu")
    beta, beta2 = (1, 2, 3, 4), (5, 6, 7, 8)
    want = tfri._fold(vals, itw, beta)
    np.testing.assert_array_equal(_np(ops.fold(vals, itw, beta)), _np(want))
    cur = convert.to_torch(_vals(51, (4, 1 << 8)))
    np.testing.assert_array_equal(_np(ops.fold_add(vals, itw, beta, cur)),
                                  _np((cur.to(torch.int64) + want) % P))
    line = convert.to_torch(_vals(52, (4, 1 << 9)))
    i1, i2 = tfri._fold_itw("l", 9, "cpu"), tfri._fold_itw("l", 8, "cpu")
    np.testing.assert_array_equal(
        _np(ops.fold2(line, i1, i2, beta, beta2)),
        _np(tfri._fold(tfri._fold(line, i1, beta), i2, beta2)))
