"""Tests that need a CUDA GPU (marker `gpu`; skipped without one). They
import no jax, so on a machine with a card and no jax they run with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from stwo_brainfuck_tpu_torch import air, tracing
from stwo_brainfuck_tpu_torch.components import device_build, tables
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES, ELEMENT_SIZES
from stwo_brainfuck_tpu_torch.core import blake2s, channel, fft, merkle, quotients
from stwo_brainfuck_tpu_torch.core.circle import point_from_t
from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig, shifted_point
from stwo_brainfuck_tpu_torch.framework import component as framework
from stwo_brainfuck_tpu_torch.ops import (blake2s_kernels, circle_fft, constraint_kernels,
                                           m31_kernels, quotient_kernels, table_kernels)
from stwo_brainfuck_tpu_torch.parallel import fft_sharded
from stwo_brainfuck_tpu_torch.parallel.prove import ShardedOps
from stwo_brainfuck_tpu_torch.parallel.merkle_sharded import commit_sharded
from stwo_brainfuck_tpu_torch.parallel.mesh import make_mesh
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine

pytestmark = pytest.mark.gpu
P = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 4, 12, 13, 14, 19, 20, 21])
def test_kernel_matches_plain_on_the_card(cuda, n):
    x = torch.as_tensor(np.random.default_rng(n).integers(0, P, (3, 1 << n)).astype(np.int32),
                        device=cuda)
    before = circle_fft.KERNEL.launches
    assert torch.equal(circle_fft.evaluate(x, n), fft.evaluate_plain(x, n))
    assert torch.equal(circle_fft.interpolate(x, n), fft.interpolate_plain(x, n))
    assert torch.equal(circle_fft.evaluate(x[0], n), fft.evaluate_plain(x[0], n))
    expect = (2 * len(circle_fft.launch_plan("evaluate", n, 3))
              + len(circle_fft.launch_plan("interpolate", n, 3)))
    assert circle_fft.KERNEL.launches - before == expect


# (24, 1): the only extend whose fused pass runs on 2^14-element tiles (radix 5)
@pytest.mark.parametrize("n, blowup", [(n, b) for n in (1, 4, 12, 13, 14, 19, 20, 21)
                                       for b in (1, 4)] + [(24, 1)])
def test_fused_extend_matches_plain_on_the_card(cuda, n, blowup):
    x = torch.as_tensor(np.random.default_rng(n + blowup).integers(0, P, (3, 1 << n))
                        .astype(np.int32), device=cuda)
    before, plain = circle_fft.KERNEL.launches, fft.PLAIN_CUDA_CALLS
    c, e = fft.extend_with_coeffs(x, n, blowup)
    assert circle_fft.KERNEL.launches - before == len(circle_fft.launch_plan("extend", n, 3, blowup))
    assert fft.PLAIN_CUDA_CALLS == plain
    cp, ep = fft.extend_plain(x, n, blowup)
    assert torch.equal(c, cp)
    assert torch.equal(e, ep)


def test_kernel_wrapper_refuses_what_it_cannot_take(cuda):
    x = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        circle_fft.evaluate(x[:, ::2], 5)       # not contiguous
    with pytest.raises(TypeError):
        circle_fft.evaluate(x.to(torch.int64), 6)


def test_small_proof_on_the_card_matches_jax_reference(cuda):
    m = create_test_machine(compile_program(chip_smoke.SMALL_CODE),
                            chip_smoke.SMALL_INPUT.encode())
    m.execute()
    fft.PLAIN_CUDA_CALLS = 0
    trees, calls = blake2s_kernels.KERNELS.launches["tree"], blake2s.PLAIN_CUDA_CALLS
    proof = air.prove_brainfuck(m, device=cuda)
    assert fft.PLAIN_CUDA_CALLS == 0
    assert blake2s_kernels.KERNELS.launches["tree"] > trees
    assert blake2s.PLAIN_CUDA_CALLS == calls
    assert chip_smoke.proof_sha256(proof) == chip_smoke.REFERENCE_SHA256["small"]
    air.verify_brainfuck(proof, device=cuda)


@pytest.mark.parametrize("d, n", [(d, n) for d in (2, 4, 8) for n in (4, 14, 16, 20)])
def test_sharded_fft_matches_one_device_on_the_card(cuda, d, n):
    """D shards on one card: every shard's local stages launch the kernel
    with the shard's twiddle table; the transforms equal the one-device
    kernel's and the plain version's, bit for bit."""
    mesh = make_mesh(d, cuda)
    for shape in ((1 << n,), (3, 1 << n)):
        x = torch.as_tensor(np.random.default_rng(n + d).integers(0, P, shape).astype(np.int32),
                            device=cuda)
        before, plain = circle_fft.KERNEL.launches, fft.PLAIN_CUDA_CALLS
        ev = fft_sharded.make_sharded_evaluate(mesh, n)(x)
        it = fft_sharded.make_sharded_interpolate(mesh, n)(x)
        coeffs, ext = fft_sharded.sharded_extend(mesh, x, n, 1)
        local = n - mesh.split_log
        per_shard = (len(circle_fft.launch_plan("evaluate", local, 1))
                     + len(circle_fft.launch_plan("interpolate", local, 1)))
        assert circle_fft.KERNEL.launches - before == d * per_shard + d * (
            len(circle_fft.launch_plan("interpolate", local, 1))
            + len(circle_fft.launch_plan("evaluate", local + 1, 1)))
        assert fft.PLAIN_CUDA_CALLS == plain
        assert all(s.is_cuda for s in ev.shards + ext.shards)
        assert torch.equal(ev.full(), circle_fft.evaluate(x, n))
        assert torch.equal(ev.full(), fft.evaluate_plain(x, n))
        assert torch.equal(it.full(), circle_fft.interpolate(x, n))
        assert torch.equal(it.full(), fft.interpolate_plain(x, n))
        want_c, want_e = fft.extend_with_coeffs(x, n, 1)
        assert torch.equal(coeffs.full(), want_c)
        assert torch.equal(ext.full(), want_e)
        assert torch.equal(ext.full(), fft.extend_plain(x, n, 1)[1])


def test_sharded_small_proof_on_the_card_matches_jax_reference(cuda):
    m = create_test_machine(compile_program(chip_smoke.SMALL_CODE),
                            chip_smoke.SMALL_INPUT.encode())
    m.execute()
    fft.PLAIN_CUDA_CALLS = 0
    before = circle_fft.KERNEL.launches
    trees, calls = blake2s_kernels.KERNELS.launches["tree"], blake2s.PLAIN_CUDA_CALLS
    proof = air.prove_brainfuck(m, device=cuda, mesh=make_mesh(8, cuda))
    assert fft.PLAIN_CUDA_CALLS == 0
    assert blake2s_kernels.KERNELS.launches["tree"] > trees
    assert blake2s.PLAIN_CUDA_CALLS == calls
    assert circle_fft.KERNEL.launches > before
    assert chip_smoke.proof_sha256(proof) == chip_smoke.REFERENCE_SHA256["small"]
    air.verify_brainfuck(proof, device=cuda)


@pytest.fixture
def cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def test_kernels_on_a_card_that_is_not_the_current_device(cards):
    """Each kernel launches on its tensor's card whichever card is current
    (a card's default stream is the handle 0, the current device's)."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, P, (8, 1 << 16)).astype(np.int32)
    want = fft.evaluate_plain(torch.as_tensor(x), 16)
    a = rng.integers(0, P, 1 << 16).astype(np.int32)
    with torch.cuda.device(cards[0]):
        for card in cards[1:]:
            got = circle_fft.evaluate(torch.as_tensor(x, device=card), 16)
            assert torch.equal(got.cpu(), want)
            t = torch.as_tensor(a, device=card)
            assert torch.equal(m31_kernels.mul(t, t).cpu(), m31_kernels.mul_plain(
                torch.as_tensor(a), torch.as_tensor(a)))


def test_mesh_over_every_card_matches_one_device(cards):
    """The one-process mesh with a shard on each card gives the one-device
    proof's bytes."""
    with open(f"{chip_smoke.ROOT}/programs/fib19_io.bf") as f:
        m = create_test_machine(compile_program(f.read()), bytes([5]))
    m.execute()
    want = air.prove_brainfuck(m, device=cards[0])
    d = 1 << (len(cards).bit_length() - 1)
    mesh = make_mesh(d, "cuda")
    assert len({str(dev) for dev in mesh.devices}) == d
    got = air.prove_brainfuck(m, device=cards[0], mesh=mesh)
    assert chip_smoke.proof_sha256(got) == chip_smoke.proof_sha256(want)


def test_one_ladder_tree_per_card(cuda):
    """The mesh names the card cuda:0 and the verifier is asked for "cuda":
    both resolve to one cache key, so the verify after a mesh prove finds
    the ladder tree the prove built."""
    m = create_test_machine(compile_program(chip_smoke.SMALL_CODE),
                            chip_smoke.SMALL_INPUT.encode())
    m.execute()
    air._preprocessed_tree.cache_clear()
    air._preprocessed_root.cache_clear()
    proof = air.prove_brainfuck(m, mesh=make_mesh(2, "cuda"))
    trees = air._preprocessed_tree.cache_info().currsize
    assert trees == 1
    air.verify_brainfuck(proof, device="cuda")
    assert air._preprocessed_tree.cache_info().currsize == trees


EDGES = [0, 1, 2**16 - 1, 2**16, P - 1]


def _m31(rng, shape, cuda):
    x = rng.integers(0, P, shape).astype(np.int32).reshape(-1)
    k = min(x.size, len(EDGES) ** 2)
    x[:k] = np.repeat(EDGES, len(EDGES))[:k] if rng.integers(2) else np.tile(EDGES, len(EDGES))[:k]
    return torch.as_tensor(x.reshape(shape), device=cuda)


@pytest.mark.parametrize("n", [1, 3, 127, 128, 4097, 1 << 20])
def test_m31_kernels_match_plain_on_the_card(cuda, n):
    rng = np.random.default_rng(n)
    a, b, c = (_m31(rng, (n,), cuda) for _ in range(3))
    launches = dict(m31_kernels.KERNELS.launches)
    assert torch.equal(m31_kernels.mul(a, b), m31_kernels.mul_plain(a, b))
    assert torch.equal(m31_kernels.mul_add(a, b, c), m31_kernels.mul_add_plain(a, b, c))
    for chain in (1, 8, 13):
        assert torch.equal(m31_kernels.mul_chain(a, b, chain),
                           m31_kernels.mul_chain_plain(a, b, chain))
    # a view at an odd offset (not 16-byte aligned) and a broadcast operand
    if n > 4:
        assert torch.equal(m31_kernels.mul(a[1:], b[:-1]), m31_kernels.mul_plain(a[1:], b[:-1]))
    col = a[: min(n, 16)].reshape(-1, 1)
    assert torch.equal(m31_kernels.mul_add(col, b[None, :], c),
                       m31_kernels.mul_add_plain(col, b[None, :], c))
    got = {k: m31_kernels.KERNELS.launches[k] - launches[k] for k in m31_kernels.KINDS}
    assert got == {"mul": 1 + (n > 4), "mul_add": 2, "mul_chain": 3}


def test_m31_edge_values_on_the_card(cuda):
    e = torch.tensor(EDGES, dtype=torch.int32, device=cuda)
    a, b = e.repeat_interleave(len(EDGES)), e.repeat(len(EDGES))
    assert torch.equal(m31_kernels.mul(a, b), m31_kernels.mul_plain(a, b))
    one = torch.ones_like(a)
    s = m31_kernels.mul_add(a, b, one)
    assert torch.equal(s, m31_kernels.mul_add_plain(a, b, one))
    assert int(s.max()) < P
    pm1 = torch.full((5,), P - 1, dtype=torch.int32, device=cuda)
    assert m31_kernels.mul(pm1, pm1).tolist() == [1] * 5
    assert m31_kernels.mul_add(pm1, torch.ones_like(pm1), torch.ones_like(pm1)).tolist() == [0] * 5


def test_device_tables_match_host_on_the_card(cuda):
    m = create_test_machine(compile_program(chip_smoke.SMALL_CODE),
                            chip_smoke.SMALL_INPUT.encode())
    m.execute()
    trace, program = m.trace(), m.program()
    meta = device_build.build_meta(trace, program)
    mats = device_build.build_device_tables(trace, meta, cuda)
    host = tables.all_tables(trace, program)
    for cls in COMPONENT_CLASSES:
        comp = cls(meta.claim[cls.name])
        want = np.stack([host[comp.name][col] for col in comp.columns]).astype(np.int32)
        assert mats[comp.name].is_cuda
        np.testing.assert_array_equal(mats[comp.name].cpu().numpy(), want, err_msg=comp.name)


def _table_trace(name: str, clk_factor: int):
    """A program's trace (the small program, or fib19_io at input 19), its
    clk multiplied by clk_factor (clk gaps of clk_factor - 1 rows)."""
    if name == "small":
        code, inp = chip_smoke.SMALL_CODE, chip_smoke.SMALL_INPUT.encode()
    else:
        with open(f"{chip_smoke.ROOT}/programs/{name}.bf") as f:
            code, inp = f.read(), chip_smoke.FIB_INPUT
    m = create_test_machine(compile_program(code), inp)
    m.execute()
    trace = m.trace().copy()
    trace[:, 0] *= np.uint32(clk_factor)
    return trace, m.program()


@pytest.mark.parametrize("name, clk_factor", [("small", 1), ("fib19_io", 1), ("small", 1000),
                                              ("fib19_io", 5)])
def test_table_kernel_matches_plain_and_host_on_the_card(cuda, name, clk_factor):
    trace, program = _table_trace(name, clk_factor)
    dm = device_build.device_meta(trace, program, cuda)
    assert dm.claim == device_build.build_meta(trace, program).claim
    launches = table_kernels.KERNEL.launches
    mats = table_kernels.KERNEL.build(dm)
    assert table_kernels.KERNEL.launches == launches + 1
    plain = table_kernels.tables_plain(dm.rows.T, dm, cuda)
    claim, again = device_build.build_tables(trace, program, cuda)
    assert claim == dm.claim and table_kernels.KERNEL.launches == launches + 2
    host = tables.all_tables(trace, program)
    for cls in COMPONENT_CLASSES:
        got = mats[cls.name]
        assert got.is_cuda and got.dtype == torch.int32
        assert torch.equal(got, plain[cls.name]), cls.name
        assert torch.equal(got, again[cls.name]), cls.name
        want = np.stack([host[cls.name][col] for col in cls.columns]).astype(np.int32)
        np.testing.assert_array_equal(got.cpu().numpy(), want, err_msg=cls.name)


def test_table_kernel_refuses_wrapping_shapes(cuda):
    trace, program = _table_trace("small", 1)
    dm = device_build.device_meta(trace, program, cuda)
    launches = table_kernels.KERNEL.launches
    for field, log in (("memory", 30), ("processor", 29), ("output_instruction", 29)):
        dm.claim = {**device_build.device_meta(trace, program, cuda).claim, field: log}
        with pytest.raises(ValueError, match="32 bits"):
            table_kernels.KERNEL.build(dm)
    assert table_kernels.KERNEL.launches == launches


# ---------------------------------------------------------------------------
# The Blake2s kernels
# ---------------------------------------------------------------------------

def _words(rng, shape, cuda):
    return torch.as_tensor(rng.integers(-2**31, 2**31, shape).astype(np.int32), device=cuda)


@pytest.mark.parametrize("cols, children, n", [
    (c, ch, n) for c in (0, 1, 4, 16, 17, 40) for ch in (False, True) for n in (1, 3, 1 << 12)
    if c or ch])
def test_blake2s_level_matches_plain_on_the_card(cuda, cols, children, n):
    rng = np.random.default_rng(cols * 7 + n)
    kids = _words(rng, (8, 2 * n), cuda) if children else None
    mat = _words(rng, (cols, n), cuda) if cols else None
    got = blake2s_kernels.KERNELS.level(kids, mat)
    assert torch.equal(got, blake2s_kernels.level_plain(kids, mat))


def test_blake2s_level_n_bytes_and_row_slices_on_the_card(cuda):
    rng = np.random.default_rng(5)
    words = _words(rng, (12, 1000), cuda)
    for n_bytes in (40, 0, 37):
        got = blake2s_kernels.KERNELS.level(None, words[:10], n_bytes)
        assert torch.equal(got, blake2s_kernels.level_plain(None, words[:10], n_bytes))
    assert torch.equal(blake2s.hash_words(words), blake2s.hash_words(words.cpu()).to(cuda))


def _tree_on_the_card(cols, children=None, max_log=None):
    """hash_levels on the card (one tree launch, no plain call) and
    tree_plain on the same tensors."""
    max_log = max(cols) if max_log is None else max_log
    launches = dict(blake2s_kernels.KERNELS.launches)
    calls = blake2s.PLAIN_CUDA_CALLS
    got = merkle.hash_levels(children, cols, max_log)
    assert blake2s.PLAIN_CUDA_CALLS == calls
    assert {k: blake2s_kernels.KERNELS.launches[k] - launches[k] for k in launches} == {
        "tree": 1, "level": 0, "grind": 0}
    return got, blake2s_kernels.tree_plain(children, cols, max_log)


def _same_layers(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), f"level {k}"


@pytest.mark.parametrize("name", list(chip_smoke.TREE_CASES))
def test_blake2s_tree_matches_plain_on_the_card(cuda, name):
    rng = np.random.default_rng(len(name))
    cols = {k: _words(rng, (c, 1 << k), cuda) for k, c in chip_smoke.TREE_CASES[name].items()}
    _same_layers(*_tree_on_the_card(cols))


def test_blake2s_tree_row_slices_and_children_on_the_card(cuda):
    """Columns as row slices of wider matrices, and children given below
    the run (the sharded top), also as a slice of wider digests."""
    rng = np.random.default_rng(3)
    wide = {k: _words(rng, (c + 3, 2 << k), cuda) for k, c in {20: 4, 16: 9, 5: 2}.items()}
    _same_layers(*_tree_on_the_card({k: m[3:, 1 << k:] for k, m in wide.items()}))
    for top, sig in ((0, {}), (2, {1: 3}), (12, {12: 2, 7: 1}), (17, {})):
        kids = _words(rng, (8, 4 << top), cuda)[:, 2 << top:]
        cols = {k: _words(rng, (c, 1 << k), cuda) for k, c in sig.items()}
        _same_layers(*_tree_on_the_card(cols, kids, top))


def test_blake2s_tree_small_prove_signatures_on_the_card(cuda):
    rng = np.random.default_rng(9)
    for sig in chip_smoke._recorded_signatures(chip_smoke.SMALL_CODE,
                                               chip_smoke.SMALL_INPUT.encode()):
        cols = {k: _words(rng, (c, 1 << k), cuda) for k, c in sig}
        got, want = _tree_on_the_card(cols)
        _same_layers(got, want)
        host = merkle.commit({k: m.cpu() for k, m in cols.items()})
        assert all(torch.equal(host.layers[k], got[k].cpu()) for k in host.layers)


def test_blake2s_two_trees_back_to_back_on_one_stream(cuda):
    rng = np.random.default_rng(10)
    trees = [{k: _words(rng, (c, 1 << k), cuda) for k, c in sig.items()}
             for sig in ({20: 4}, {19: 8, 18: 57, 10: 1})]
    got = [merkle.hash_levels(None, cols, max(cols)) for cols in trees]  # no sync between
    for layers, cols in zip(got, trees):
        _same_layers(layers, blake2s_kernels.tree_plain(None, cols, max(cols)))


def test_blake2s_tree_repeated_commits_agree(cuda):
    """The cross-CTA reads: 50 commits of one large tree back to back, each
    equal to the plain tree."""
    rng = np.random.default_rng(11)
    cols = {k: _words(rng, (c, 1 << k), cuda) for k, c in {21: 8, 20: 57, 19: 4, 12: 1}.items()}
    want = blake2s_kernels.tree_plain(None, cols, 21)
    runs = [merkle.hash_levels(None, cols, 21) for _ in range(chip_smoke.TREE_REPEATS)]
    for layers in runs:
        _same_layers(layers, want)


def test_blake2s_commit_over_four_shards_of_the_card(cuda):
    """D = 4 shards sharing the card: one tree launch a shard and one for
    the top, the layers and root equal to one device's."""
    rng = np.random.default_rng(12)
    cols = {k: _words(rng, (c, 1 << k), cuda) for k, c in {18: 3, 12: 5, 1: 2}.items()}
    launches = blake2s_kernels.KERNELS.launches["tree"]
    tree = commit_sharded(make_mesh(4, cuda), cols)
    assert blake2s_kernels.KERNELS.launches["tree"] - launches == 5
    single = merkle.commit(cols)
    assert tree.root == single.root
    for k, layer in single.layers.items():
        got = tree.layers[k]
        assert torch.equal(got if isinstance(got, torch.Tensor) else got.full(), layer)


@pytest.mark.parametrize("tree", [{3: 4}, {12: 4}, {14: 3, 12: 17, 9: 1, 4: 2},
                                  {k: 1 for k in range(13, 2, -1)}, {1: 2, 0: 5}])
def test_merkle_commit_on_the_card_matches_cpu(cuda, tree):
    rng = np.random.default_rng(len(tree))
    cols = {k: rng.integers(0, P, (c, 1 << k)).astype(np.int32) for k, c in tree.items()}
    launches = dict(blake2s_kernels.KERNELS.launches)
    calls = blake2s.PLAIN_CUDA_CALLS
    got = merkle.commit({k: torch.as_tensor(v, device=cuda) for k, v in cols.items()})
    want = merkle.commit({k: torch.as_tensor(v) for k, v in cols.items()})
    plan = blake2s_kernels.launch_plan([(k, v.shape[0]) for k, v in cols.items()])
    for kind in blake2s_kernels.ENTRIES:
        assert blake2s_kernels.KERNELS.launches[kind] - launches[kind] == sum(
            s[0] == kind for s in plan)
    assert blake2s.PLAIN_CUDA_CALLS == calls
    assert got.root == want.root
    for k in want.layers:
        assert torch.equal(got.layers[k].cpu(), want.layers[k]), f"level {k}"


@pytest.mark.parametrize("pow_bits", range(8, 21))
def test_blake2s_grind_matches_the_host_loop(cuda, pow_bits):
    digest = np.random.default_rng(pow_bits).integers(0, 256, 32).astype(np.uint8).tobytes()
    want = 0
    while not channel._check_pow(digest, pow_bits, want):
        want += 1
    assert blake2s_kernels.KERNELS.grind(digest, pow_bits, cuda) == want
    assert channel._device_grind(digest, pow_bits, cuda) == want


def test_small_proof_at_pow_bits_16_on_the_card(cuda):
    m = create_test_machine(compile_program(chip_smoke.SMALL_CODE),
                            chip_smoke.SMALL_INPUT.encode())
    m.execute()
    grinds = blake2s_kernels.KERNELS.launches["grind"]
    calls = blake2s.PLAIN_CUDA_CALLS
    proof = air.prove_brainfuck(m, PcsConfig(log_max_rows=0, pow_bits=16), device=cuda)
    assert blake2s_kernels.KERNELS.launches["grind"] > grinds
    assert blake2s.PLAIN_CUDA_CALLS == calls
    assert chip_smoke.proof_sha256(proof) == chip_smoke.REFERENCE_SHA256["small_pow16"]
    air.verify_brainfuck(proof, device=cuda)


def _quotient_case(seed, log_size, n_cols, n_groups, device):
    """(n_cols, 2^log_size) int32 columns on `device` and the point groups
    of claims at n_groups points (every column at z, column c also at
    z - s g for s = c % n_groups > 0)."""
    rng = np.random.default_rng(seed)
    cols = torch.as_tensor(rng.integers(0, P, (n_cols, 1 << log_size)).astype(np.int32),
                           device=device)
    felt = lambda: tuple(int(v) for v in rng.integers(0, P, 4))  # noqa: E731
    z = point_from_t(felt())
    claims, aidx = [], 0
    for c in range(n_cols):
        cl = []
        for shift in sorted({0, c % n_groups}):
            cl.append(quotients.QuotientClaim(shifted_point(z, log_size - 1, shift), felt(), aidx))
            aidx += 1
        claims.append(cl)
    alpha = felt()
    return cols, quotients.point_groups({log_size: claims}, alpha)[log_size]


@pytest.mark.parametrize("log_size, n_groups", [(lg, g) for lg in (5, 8, 13, 17, 22)
                                                for g in (1, 2, 3)])
def test_quotient_kernel_matches_plain_on_the_card(cuda, log_size, n_groups):
    cols, groups = _quotient_case(log_size, log_size, 7, n_groups, cuda)
    before, plain = quotient_kernels.KERNEL.launches, quotients.PLAIN_CUDA_CALLS
    got = quotients.accumulate_range(log_size, list(cols), groups)
    assert quotient_kernels.KERNEL.launches - before == 1
    assert quotients.PLAIN_CUDA_CALLS == plain
    assert torch.equal(got, quotients.accumulate_plain(log_size, list(cols), groups))
    px, py = quotients.domain_points_storage(log_size, cuda)
    assert torch.equal(got, quotients.accumulate_groups(list(cols), groups, px, py))


@pytest.mark.parametrize("offset, n", [(1, 1000), (12345, 77777), ((1 << 20) - 3, 3),
                                       (7, (1 << 20) - 7)])
def test_quotient_kernel_at_odd_offsets_on_the_card(cuda, offset, n):
    cols, groups = _quotient_case(offset, 20, 70, 3, cuda)
    part = [c[offset:offset + n] for c in cols]
    got = quotient_kernels.KERNEL.accumulate(20, part, groups, offset)
    assert torch.equal(got, quotients.accumulate_plain(20, part, groups, offset))


@pytest.mark.parametrize("d", [2, 4, 8])
def test_quotient_kernel_on_mesh_shards(cuda, d):
    """ShardedOps.accumulate_all: one launch a shard, at its chunk's offset,
    equal to the one-device kernel."""
    cols, groups = _quotient_case(d, 18, 5, 2, cuda)
    ops = ShardedOps(make_mesh(d, "cuda"))
    before = quotient_kernels.KERNEL.launches
    got = ops.accumulate_all(18, list(cols), groups)
    assert quotient_kernels.KERNEL.launches - before == d
    assert torch.equal(got.full(), quotients.accumulate_range(18, list(cols), groups))


def test_accumulate_quotients_on_the_card_equals_each_size_alone(cuda):
    """A prove's sizes through accumulate_quotients: one launch a size, the
    largest first, each output the plain version's with that size's groups."""
    rng = np.random.default_rng(9)
    felt = lambda: tuple(int(v) for v in rng.integers(0, P, 4))  # noqa: E731
    z = point_from_t(felt())
    inputs, aidx = {}, 0
    for log_size, n_cols in ((12, 5), (20, 4), (16, 9)):
        cols = [torch.as_tensor(rng.integers(0, P, 1 << log_size).astype(np.int32), device=cuda)
                for _ in range(n_cols)]
        claims = []
        for c in range(n_cols):
            claims.append([quotients.QuotientClaim(shifted_point(z, log_size - 1, s), felt(),
                                                   aidx + k)
                           for k, s in enumerate(sorted({0, c % 3}))])
            aidx += len(claims[-1])
        inputs[log_size] = (cols, claims)
    alpha = felt()
    before = quotient_kernels.KERNEL.launches
    got = quotients.accumulate_quotients(inputs, alpha)
    assert quotient_kernels.KERNEL.launches - before == len(inputs)
    assert list(got) == sorted(inputs, reverse=True)
    groups = quotients.point_groups({s: claims for s, (_cols, claims) in inputs.items()}, alpha)
    for log_size, (cols, _claims) in inputs.items():
        assert torch.equal(got[log_size], quotients.accumulate_plain(log_size, cols,
                                                                     groups[log_size]))


def test_quotient_kernel_wrapper_refuses_what_it_cannot_take(cuda):
    cols, groups = _quotient_case(0, 8, 3, 1, cuda)
    with pytest.raises(TypeError):
        quotient_kernels.KERNEL.accumulate(8, [c.to(torch.int64) for c in cols], groups)
    with pytest.raises(ValueError):
        quotient_kernels.KERNEL.accumulate(8, [c[::2] for c in cols], groups)
    with pytest.raises(ValueError):
        quotient_kernels.KERNEL.accumulate(8, list(cols), groups, offset=1)
    with pytest.raises(ValueError):
        quotient_kernels.KERNEL.accumulate(8, [cols[0], cols[1].cpu(), cols[2]], groups)


def _zero_line_groups(groups):
    """groups with the first group's dy, dx and vc set to 0: its vanishing
    value is 0 at every position, so every batch of the kernel meets zero
    norms (inv(0) = 0)."""
    consts = groups[0][0].copy()
    consts[2:] = 0
    return [(consts, *groups[0][1:])] + list(groups[1:])


@pytest.mark.parametrize("log_size, n_groups, offset, n", [
    (10, 1, 0, 1024), (10, 2, 0, 1024), (12, 1, 1024, 1024), (12, 3, 2048, 512),
    (9, 1, 5, 100), (9, 2, 0, 7), (8, 1, 0, 256), (8, 1, 0, 128), (20, 1, 0, 1 << 20),
    (20, 2, 3 << 18, 1 << 18)])
def test_quotient_kernel_equals_its_emulation_with_zero_lines(cuda, log_size, n_groups, offset,
                                                              n):
    cols, groups = _quotient_case(log_size + n, log_size, 5, n_groups, cuda)
    part = [c[offset:offset + n] for c in cols]
    for gs in (groups, _zero_line_groups(groups)):
        got = quotient_kernels.KERNEL.accumulate(log_size, part, gs, offset)
        assert torch.equal(got, quotients.accumulate_plain(log_size, part, gs, offset))
        assert torch.equal(got, quotient_kernels.emulate(log_size, part, gs, offset))


def test_quotient_schedule_mirrors_the_kernel(cuda):
    import ctypes

    lib = quotient_kernels.KERNEL.lib.load()
    out = (ctypes.c_longlong * 3)()
    for n_groups in (1, 2, 5):
        for log_n in range(0, 29):
            for n, offset in ((1 << log_n, 0), (1 << log_n, 3 << log_n), ((1 << log_n) + 3, 0),
                              (1 << log_n, 1)):
                lib.quotients_schedule(n_groups, offset, n, ctypes.addressof(out))
                assert (out[0], bool(out[1]), out[2]) == quotient_kernels.schedule(
                    n_groups, offset, n)


def _scan_case(seed, n, dev, edge=False):
    rng = np.random.default_rng(seed)
    values = np.array([0, 1, P - 2, P - 1]) if edge else None
    x = values[rng.integers(0, 4, (4, n))] if edge else rng.integers(0, P, (4, n))
    return torch.as_tensor(x.astype(np.int32), device=dev)


@pytest.mark.parametrize("log_n", list(range(2, 23)))
def test_scan_matches_plain_on_the_card(cuda, log_n):
    launches, plain = dict(constraint_kernels.KERNELS.launches), framework.PLAIN_CUDA_CALLS
    perm = fft.coset_order_permutation(log_n, cuda)
    for edge in (False, True):
        total = _scan_case(log_n, 1 << log_n, cuda, edge)
        s, claimed = framework.prefix_sum(total)
        assert framework.PLAIN_CUDA_CALLS == plain
        want, want_claimed = framework.prefix_sum_plain(total, perm)
        plain = framework.PLAIN_CUDA_CALLS
        assert torch.equal(s, want) and torch.equal(claimed, want_claimed)
        if log_n <= 16:
            resident = constraint_kernels.KERNELS.geometry("scan", log_n, cuda)[6]
            es, ec = constraint_kernels.emulate_scan(total, max_tiles=resident)
            assert torch.equal(es, s) and torch.equal(ec, claimed)
    assert constraint_kernels.KERNELS.launches == {**launches, "scan": launches["scan"] + 2}


@pytest.mark.parametrize("n", [1, 5, 2047, 2048, 2049, 1 << 16, (1 << 20) + 77])
def test_linear_scan_with_a_carry_on_the_card(cuda, n):
    x = _scan_case(n, n, cuda)
    carry = torch.as_tensor(np.random.default_rng(n).integers(0, P, 4).astype(np.int32),
                            device=cuda)
    for c in (None, carry):
        s, last = constraint_kernels.KERNELS.scan(x, False, c)
        want, want_last = framework.prefix_sum_plain(x, None, c)
        assert torch.equal(s, want) and torch.equal(last, want_last)


def test_scan_geometry_and_refusals_on_the_card(cuda):
    import ctypes

    lib = constraint_kernels.KERNELS.scan_lib.load()
    out = (ctypes.c_int * 7)()
    for log_n in range(2, 31):
        assert lib.logup_scan_geometry(log_n, ctypes.addressof(out)) == 0
        assert tuple(out)[:5] == constraint_kernels.scan_geometry(log_n, out[6])
        assert out[3] <= out[6]  # every tile resident
    x = _scan_case(0, 64, cuda)
    with pytest.raises(TypeError):
        constraint_kernels.KERNELS.scan(x.to(torch.int64))
    with pytest.raises(ValueError):
        constraint_kernels.KERNELS.scan(x[:, :48].contiguous())
    with pytest.raises(ValueError):
        constraint_kernels.KERNELS.scan(x[:, ::2])
    with pytest.raises(ValueError):
        constraint_kernels.KERNELS.scan(x, True, x[:, 0].contiguous())


def test_mesh_prefix_sum_uses_the_scan_on_the_card(cuda):
    from stwo_brainfuck_tpu_torch.parallel import sharded

    x = _scan_case(11, 1 << 16, cuda)
    mesh = make_mesh(4, "cuda")
    before, plain = constraint_kernels.KERNELS.launches["scan"], framework.PLAIN_CUDA_CALLS
    out, claimed = sharded.prefix_sum(mesh, mesh.shard(x).shards)
    assert constraint_kernels.KERNELS.launches["scan"] - before == 4
    assert framework.PLAIN_CUDA_CALLS == plain
    want, want_claimed = framework.prefix_sum_plain(x)
    assert torch.equal(torch.cat(out, 1), want) and torch.equal(claimed, want_claimed)


def test_quotient_kernel_and_grind_on_a_card_that_is_not_the_current_device(cards):
    cols, groups = _quotient_case(9, 16, 4, 2, "cpu")
    want = quotients.accumulate_range(16, list(cols), groups)
    digest = bytes(range(32))
    nonce = 0
    while not channel._check_pow(digest, 14, nonce):
        nonce += 1
    with torch.cuda.device(cards[0]):
        for card in cards[1:]:
            got = quotients.accumulate_range(16, [c.to(card) for c in cols], groups)
            assert got.device == card
            assert torch.equal(got.cpu(), want)
            assert blake2s_kernels.KERNELS.grind(digest, 14, card) == nonce


def _constraint_case(cls, log, blow, seed, dev):
    """Seeded canonical inputs of one component's composition and logup on
    `dev`."""
    rng = np.random.default_rng(seed)
    m = 1 << (log + blow)

    def rows(k, size):
        return [torch.as_tensor(rng.integers(0, P, size).astype(np.int32), device=dev)
                for _ in range(k)]

    def felt():
        return tuple(int(v) for v in rng.integers(0, P, 4))

    comp = cls(log)
    els = {k: framework.LookupElements(z=felt(), alpha=felt(), size=s)
           for k, s in ELEMENT_SIZES.items()}
    return comp, rows, felt, els, m


def _composition_segment(comp, rows, felt, m, log, blow, dev, offset=0, alpha_offset=9):
    """One component's composition segment of seeded rows on `dev`, S(p -
    g) through the rotation index."""
    main = dict(zip(comp.columns, rows(len(comp.columns), m)))
    inter = rows(4 * (comp.relation_count() + 1), m)
    member = framework.CompositionMember(comp, main, inter, inter[-4:], felt(), alpha_offset)
    return framework.CompositionSegment(log, [member], rows(1, m)[0],
                                        fft.rotation_index(log, blow, dev), offset)


@pytest.mark.parametrize("blow", [1, 4])
@pytest.mark.parametrize("log", [5, 16])
@pytest.mark.parametrize("cls", COMPONENT_CLASSES, ids=lambda c: c.name)
def test_constraint_kernels_match_plain_on_the_card(cuda, cls, log, blow):
    comp, rows, felt, els, m = _constraint_case(cls, log, blow, log * 10 + blow, cuda)
    seg = _composition_segment(comp, rows, felt, m, log, blow, cuda)
    alpha = felt()
    launches, plain = dict(constraint_kernels.KERNELS.launches), framework.PLAIN_CUDA_CALLS
    (out,) = framework.composition_evaluate([seg], els, alpha, blow)
    assert out.shape == (4, m) and out.dtype == torch.int32
    assert framework.PLAIN_CUDA_CALLS == plain
    want = framework.composition_segment_plain(seg, els, alpha, blow)
    assert torch.equal(out, want)
    # logup on the trace domain's rows
    n = 1 << log
    lmain = {k: v[:n].contiguous() for k, v in seg.members[0].main_cols.items()}
    isf = seg.is_first
    q, total = framework.logup_fractions(comp, lmain, isf[:n].contiguous(), els)
    wq, wtotal = framework.logup_fractions_plain(comp, lmain, isf[:n].contiguous(), els)
    assert torch.equal(q, wq) and torch.equal(total.to(torch.int64), wtotal)
    assert constraint_kernels.KERNELS.launches == {
        **launches, "composition": launches["composition"] + 1, "logup": launches["logup"] + 1}


def test_constraint_kernel_chunks_and_refusals_on_the_card(cuda):
    """Four chunks at their offsets (S(p - g) given as rows, as the mesh
    gives them) and every component of three sizes, each as segments of
    one launch, equal the plain version; the refusals."""
    cls = COMPONENT_CLASSES[3]  # processor: three relations
    comp, rows, felt, els, m = _constraint_case(cls, 10, 2, 7, cuda)
    whole = _composition_segment(comp, rows, felt, m, 10, 2, cuda, alpha_offset=0)
    alpha = felt()
    mem = whole.members[0]
    s_prev = torch.stack(mem.s_rows)[:, whole.rotation.to(torch.int64)]
    c = m // 4
    segs = [whole]
    for i in range(4):
        sl = slice(i * c, (i + 1) * c)
        segs.append(framework.CompositionSegment(10, [framework.CompositionMember(
            comp, {k: v[sl] for k, v in mem.main_cols.items()}, [r[sl] for r in mem.inter_rows],
            [r[sl] for r in s_prev], mem.claimed_sum, 0)], whole.is_first[sl], None, i * c))
    before = constraint_kernels.KERNELS.launches["composition"]
    outs = framework.composition_evaluate(segs, els, alpha, 2)
    assert constraint_kernels.KERNELS.launches["composition"] == before + 1
    assert torch.equal(outs[0], framework.composition_segment_plain(whole, els, alpha, 2))
    for i in range(4):
        assert torch.equal(outs[1 + i], outs[0][:, i * c:(i + 1) * c])
    # every component at sizes 2^4, 2^5, 2^6 in one launch
    segs, off = [], 0
    for log in (4, 5, 6):
        members = []
        for k, cl in enumerate(COMPONENT_CLASSES):
            if k % 3 != log % 3:
                continue
            cmp_, rws, flt, _, mm = _constraint_case(cl, log, 2, 100 * log + k, cuda)
            seg = _composition_segment(cmp_, rws, flt, mm, log, 2, cuda, alpha_offset=off)
            off += cmp_.constraint_count()
            members += seg.members
        segs.append(framework.CompositionSegment(log, members, seg.is_first, seg.rotation))
    for got, seg in zip(framework.composition_evaluate(segs, els, alpha, 2), segs):
        assert torch.equal(got, framework.composition_segment_plain(seg, els, alpha, 2))
    with pytest.raises(TypeError):
        bad = framework.CompositionMember(comp, {**mem.main_cols,
                                                 "clk": mem.main_cols["clk"].to(torch.int64)},
                                          mem.inter_rows, mem.s_rows, mem.claimed_sum, 0)
        framework.composition_evaluate([framework.CompositionSegment(
            10, [bad], whole.is_first, whole.rotation)], els, alpha, 2)
    with pytest.raises(ValueError):
        framework.composition_evaluate([framework.CompositionSegment(
            10, [mem], whole.is_first, whole.rotation, 1)], els, alpha, 2)
    with pytest.raises(ValueError):
        constraint_kernels.KERNELS.logup(comp, {**mem.main_cols,
                                                "clk": mem.main_cols["clk"][::2]},
                                         whole.is_first, els)


def test_fib19_io_prove_launches_each_constraint_kernel_once_a_component(cuda):
    """A one-device fib19_io prove: the interaction kernel once a
    component, the composition kernel once a prove, no logup or scan
    launch and no plain constraint call; the recorded sha256."""
    with open(chip_smoke.os.path.join(chip_smoke.ROOT, "programs", "fib19_io.bf")) as f:
        m = create_test_machine(compile_program(f.read()), chip_smoke.FIB_INPUT)
    m.execute()
    launches, plain = dict(constraint_kernels.KERNELS.launches), framework.PLAIN_CUDA_CALLS
    proof = air.prove_brainfuck(m, device=cuda)
    assert framework.PLAIN_CUDA_CALLS == plain
    want = {"composition": 1, "interaction": len(COMPONENT_CLASSES), "logup": 0, "scan": 0}
    for family in constraint_kernels.FAMILIES:
        assert constraint_kernels.KERNELS.launches[family] - launches[family] == want[family]
    assert chip_smoke.proof_sha256(proof) == chip_smoke.REFERENCE_SHA256["fib19_io"]


def _interaction_case(cls, log, seed, dev, edge=False):
    """Seeded main columns and lookup elements of one component's
    interaction on `dev`; edge: values 0, 1, p - 2, p - 1 and the
    elements' z moved so that denominators are 0 at some rows."""
    rng = np.random.default_rng(seed)
    comp = cls(log)
    n = 1 << log
    values = np.array([0, 1, P - 2, P - 1])
    main = {c: torch.as_tensor((values[rng.integers(0, 4, n)] if edge else
                                rng.integers(0, P, n)).astype(np.int32), device=dev)
            for c in comp.columns}

    def felt():
        return tuple(int(v) for v in rng.integers(0, P, 4))

    els = {k: framework.LookupElements(z=felt(), alpha=felt(), size=s)
           for k, s in ELEMENT_SIZES.items()}
    if edge:
        els = chip_smoke.zero_den_elements(comp, main, els, [0, 1, n - 2, n // 2 + 1])
    return comp, main, els


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("log", [2, 4, 11, 16])
@pytest.mark.parametrize("cls", COMPONENT_CLASSES, ids=lambda c: c.name)
def test_interaction_kernel_matches_plain_on_the_card(cuda, cls, log, edge):
    comp, main, els = _interaction_case(cls, log, log * 3 + edge, cuda, edge)
    launches, plain = dict(constraint_kernels.KERNELS.launches), framework.PLAIN_CUDA_CALLS
    cols, claimed = framework.build_interaction_trace_async(comp, main, els)
    assert framework.PLAIN_CUDA_CALLS == plain
    assert constraint_kernels.KERNELS.launches == {
        **launches, "interaction": launches["interaction"] + 1}
    q, s, want_claimed = framework.interaction_plain(comp, main, els)
    assert torch.equal(torch.stack(cols[:-1]), q) and torch.equal(cols[-1], s)
    assert torch.equal(claimed, want_claimed)
    resident = constraint_kernels.KERNELS.geometry(cls, log, cuda)[6]
    eq, es, ec = constraint_kernels.emulate_interaction(comp, main, els, resident)
    assert torch.equal(eq, q) and torch.equal(es, s) and torch.equal(ec, claimed)


@pytest.mark.parametrize("cls, log", [(COMPONENT_CLASSES[0], 20), (COMPONENT_CLASSES[3], 22),
                                      (COMPONENT_CLASSES[1], 18)], ids=lambda v: str(v))
def test_interaction_kernel_at_the_provers_sizes(cuda, cls, log):
    """On chip and in the scratch (the planned geometry says which)."""
    comp, main, els = _interaction_case(cls, log, log, cuda)
    got = constraint_kernels.KERNELS.interaction(comp, main, els)
    want = framework.interaction_plain(comp, main, els)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_interaction_geometry_on_the_card(cuda):
    import ctypes

    lib = constraint_kernels.KERNELS.lib.load()
    out = (ctypes.c_int * 7)()
    for cls in COMPONENT_CLASSES:
        for log_n in range(2, 31):
            assert lib.constraints_interaction_geometry(
                constraint_kernels.COMPONENT_IDS[cls.name], log_n, ctypes.addressof(out)) == 0
            assert tuple(out)[:5] == constraint_kernels.scan_geometry(log_n, out[6])
            assert out[3] <= out[6] and out[6] >= 132  # every tile resident, every SM a CTA
            if out[5]:
                assert constraint_kernels.on_chip_bytes(log_n, out[6]) <= 96 * 1024


def test_interaction_head_resets_itself(cuda):
    """Back-to-back launches of different sizes and modes, no sync between
    them: each equals its plain version and the head is zero after."""
    cases = [_interaction_case(COMPONENT_CLASSES[i], log, 50 + log, cuda)
             for i, log in ((0, 20), (3, 6), (1, 16), (3, 22), (0, 20), (2, 2))]
    outs = []
    for comp, main, els in cases:
        outs.append(constraint_kernels.KERNELS.interaction(comp, main, els))
        # the coset scan shares the head
        total = _scan_case(len(outs), 1 << 12, cuda)
        outs.append((total, *constraint_kernels.KERNELS.scan(total)))
    torch.cuda.synchronize()
    assert not any(constraint_kernels.KERNELS.head(COMPONENT_CLASSES[0], cuda))
    assert not any(constraint_kernels.KERNELS.head("scan", cuda))
    for i, (comp, main, els) in enumerate(cases):
        for g, w in zip(outs[2 * i], framework.interaction_plain(comp, main, els)):
            assert torch.equal(g, w)
        total, s, claimed = outs[2 * i + 1]
        want, want_claimed = framework.prefix_sum_plain(
            total, fft.coset_order_permutation(12, cuda))
        assert torch.equal(s, want) and torch.equal(claimed, want_claimed)


def test_logup_kernel_with_zero_denominators_on_the_card(cuda):
    for cls in COMPONENT_CLASSES:
        comp, main, els = _interaction_case(cls, 10, 77, cuda, edge=True)
        n = 1 << 10
        isf = torch.zeros(n, dtype=torch.int32, device=cuda)
        isf[0] = 1
        for rows in (n, n - 3):  # a ragged last thread
            sub = {k: v[:rows] for k, v in main.items()}
            q, total = constraint_kernels.KERNELS.logup(comp, sub, isf[:rows], els)
            wq, wtotal = framework.logup_fractions_plain(comp, sub, isf[:rows], els)
            assert torch.equal(q, wq) and torch.equal(total.to(torch.int64), wtotal)


# ---------------------------------------------------------------------------
# The OODS kernel (csrc/oods.cu) and the FRI fold kernel (csrc/fri_fold.cu)
# ---------------------------------------------------------------------------

def _felt(rng):
    return tuple(int(v) for v in rng.integers(0, P, 4))


def _oods_groups(seed, logs, rows_each, dev):
    rng = np.random.default_rng(seed)
    counts = rows_each if isinstance(rows_each, list) else [rows_each] * len(logs)
    return [(lg, (_felt(rng), _felt(rng)),
             [torch.as_tensor(rng.integers(0, P, 1 << lg).astype(np.int32), device=dev)
              for _ in range(k)]) for lg, k in zip(logs, counts)]


# odd and even trace logs; (4, 5, 6, 21): many small rows packed beside one
# 2^21 row, the mix a prove's launch has
@pytest.mark.parametrize("logs", [[1], [2, 3, 4, 5], [4, 8, 9, 12, 13], [16, 17, 18],
                                  [20, 21], [22], [24], [10, 11], [23],
                                  [4, 5, 6, 21]])
def test_oods_kernel_matches_plain_on_the_card(cuda, logs):
    from stwo_brainfuck_tpu_torch.core import poly
    from stwo_brainfuck_tpu_torch.ops import oods_kernels

    rows_each = [40, 30, 50, 1] if logs == [4, 5, 6, 21] else 3
    groups = _oods_groups(sum(logs), logs, rows_each, cuda)
    before, plain = oods_kernels.KERNEL.launches, poly.PLAIN_CUDA_CALLS
    got = poly.sample_groups(groups)
    assert oods_kernels.KERNEL.launches - before == 1
    assert poly.PLAIN_CUDA_CALLS == plain
    cpu = [(lg, pt, [r.cpu() for r in rows]) for lg, pt, rows in groups]
    assert torch.equal(got.cpu(), poly.sample_groups(cpu))
    if max(logs) <= 18:
        assert torch.equal(got, oods_kernels.emulate(groups))


@pytest.mark.parametrize("d", [2, 4, 8])
def test_oods_kernel_on_mesh_shards(cuda, d):
    """ShardedOps.sample_groups: one launch a shard (shard 0's with the rows
    that are not sharded), one sum, equal to the one-device launch."""
    from stwo_brainfuck_tpu_torch.core import poly
    from stwo_brainfuck_tpu_torch.ops import oods_kernels

    groups = _oods_groups(d, [4, 10, 15, 18], 3, cuda)
    ops = ShardedOps(make_mesh(d, "cuda"))
    mixed = [(lg, pt, [ops.mesh.shard(rows[0]), rows[1], ops.mesh.shard(rows[2])])
             for lg, pt, rows in groups]
    before = oods_kernels.KERNEL.launches
    got = ops.sample_groups(mixed)
    assert oods_kernels.KERNEL.launches - before == d
    assert torch.equal(got, poly.sample_groups(groups))


@pytest.mark.parametrize("points", [2, 3])
def test_oods_kernel_reads_a_row_at_two_points_once(cuda, points):
    """Rows opened at several points of one trace log, as a prove's shifted
    groups have them (2^9 and longer: pairs; shorter: a member a point),
    whole and as a shard's chunks: equal to the plain version."""
    from stwo_brainfuck_tpu_torch.core import poly
    from stwo_brainfuck_tpu_torch.ops import oods_kernels

    base = _oods_groups(points, [4, 9, 12, 19], 3, cuda)
    rng = np.random.default_rng(points)
    groups = base + [(lg, (_felt(rng), _felt(rng)), rows[:2]) for lg, _, rows in base
                     for _ in range(points - 1)]
    lp = oods_kernels.plan(groups, 0, 8, cuda=True)
    assert lp.n_pairs == 6  # the 2^9, 2^12 and 2^19 rows at a second point
    cpu = [(lg, pt, [r.cpu() for r in rows]) for lg, pt, rows in groups]
    assert torch.equal(poly.sample_groups(groups).cpu(), poly.sample_groups(cpu))
    half = [(lg, pt, [r[:r.shape[0] // 2] for r in rows]) for lg, pt, rows in groups]
    cpu = [(lg, pt, [r.cpu() for r in rows]) for lg, pt, rows in half]
    assert torch.equal(poly.sample_groups(half, shard=1).cpu(), poly.sample_groups(cpu, shard=1))


def test_oods_kernel_unaligned_rows_and_many_groups(cuda):
    """A big row that does not start on 16 bytes (read from an aligned
    copy), a group of all-None rows, and more than MAX_GROUPS groups (one
    launch each MAX_GROUPS): equal to the plain version."""
    from stwo_brainfuck_tpu_torch.core import poly
    from stwo_brainfuck_tpu_torch.ops import oods_kernels

    rng = np.random.default_rng(5)
    long = torch.as_tensor(rng.integers(0, P, (1 << 12) + 4).astype(np.int32), device=cuda)
    groups = _oods_groups(6, [12, 7], 2, cuda)
    groups[0][2].append(long[1:1 + (1 << 12)])
    groups.append((9, (_felt(rng), _felt(rng)), [None, None]))
    many = groups + _oods_groups(7, [5 + k % 9 for k in range(oods_kernels.MAX_GROUPS + 3)], 1,
                                 cuda)
    for gs, launches in ((groups, 1), (many, 2)):
        before = oods_kernels.KERNEL.launches
        got = poly.sample_groups(gs)
        assert oods_kernels.KERNEL.launches - before == launches
        cpu = [(lg, pt, [None if r is None else r.cpu() for r in rows]) for lg, pt, rows in gs]
        assert torch.equal(got.cpu(), poly.sample_groups(cpu))


def test_oods_schedule_mirrors_the_kernel_and_refusals(cuda):
    import ctypes

    from stwo_brainfuck_tpu_torch.core import poly
    from stwo_brainfuck_tpu_torch.ops import oods_kernels

    lib = oods_kernels.KERNEL.lib.load()
    blocks = oods_kernels.KERNEL.max_blocks(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert blocks % sms == 0 and blocks >= sms
    out = (ctypes.c_longlong * 6)()
    for rows in ((0, 4, 0), (5, 0, 0), (0, 0, 8), (3, 42_600, 7_600), (1, 332_000, 126_000),
                 (7, 2**24, 2**20)):
        sch = oods_kernels.schedule(*rows, blocks)
        for b in range(sch.grid):
            assert lib.oods_schedule(b, sch.grid, *rows, ctypes.addressof(out)) == 0
            assert tuple(out) == tuple(int(v[b]) for v in sch[1:])
    attrs = oods_kernels.KERNEL.attributes()
    assert attrs["registers"] > 0 and attrs["local_bytes"] == 0
    groups = _oods_groups(1, [8], 2, cuda)
    lg, pt, rows = groups[0]
    with pytest.raises(TypeError):
        poly.sample_groups([(lg, pt, [r.to(torch.int64) for r in rows])])
    with pytest.raises(ValueError):
        poly.sample_groups([(lg, pt, [r[::2].contiguous()[:100] for r in rows])])
    with pytest.raises(ValueError):
        poly.sample_groups([(lg, pt, [rows[0], rows[1].cpu()])])
    with pytest.raises(ValueError):
        poly.sample_groups([(lg, pt, [rows[0][::2]])])


def _fold_cases(seed, top, dev):
    """(step, values, inject_a, inject_b) for every mode of the fold kernel
    at levels up to 2^top."""
    from stwo_brainfuck_tpu_torch.core import fri

    rng = np.random.default_rng(seed)

    def arr(n):
        return torch.as_tensor(rng.integers(0, P, (4, n)).astype(np.int32), device=dev)

    b, b2, b0 = _felt(rng), _felt(rng), _felt(rng)
    cases = [(fri.FoldStep(top, 1, True, b0, b0, b0, top), arr(1 << top), None, None),
             (fri.FoldStep(top - 1, 0, False, b, b2, b0, top), arr(1 << (top - 1)), None,
              arr(1 << top))]
    for level in sorted({top - 1, 3, 2} & set(range(2, top))):
        for folds in (1, 2):
            if level - folds < 1:
                continue
            n = 1 << (level - folds)
            for with_a in ((False, True) if folds == 2 else (False,)):
                for with_b in (False, True):
                    cases.append((fri.FoldStep(level, folds, False, b, b2, b0, top),
                                  arr(1 << level), arr(4 * n) if with_a else None,
                                  arr(2 * n) if with_b else None))
    return cases


@pytest.mark.parametrize("top", [3, 10, 21])
def test_fold_kernel_matches_plain_on_the_card(cuda, top):
    from stwo_brainfuck_tpu_torch.core import fri
    from stwo_brainfuck_tpu_torch.ops import fri_kernels

    for step, v, a, b in _fold_cases(top, top, cuda):
        before, plain = fri_kernels.KERNEL.launches, fri.PLAIN_CUDA_CALLS
        got = fri_kernels.KERNEL.fold(v, step, a, b)
        assert fri_kernels.KERNEL.launches - before == 1
        assert fri.PLAIN_CUDA_CALLS == plain
        cpu = lambda x: None if x is None else x.cpu()  # noqa: E731
        assert torch.equal(got.cpu(), fri.fold_step_plain(v.cpu(), step, cpu(a), cpu(b))), step
        if top <= 10:
            assert torch.equal(got, fri_kernels.emulate(v, step, a, b))


@pytest.mark.parametrize("d", [2, 4])
def test_fold_kernel_on_mesh_shards(cuda, d):
    """ShardedOps.fold_step: one launch a shard at its chunk's offset, equal
    to the one-device launch, for every mode."""
    from stwo_brainfuck_tpu_torch.core import fri
    from stwo_brainfuck_tpu_torch.ops import fri_kernels

    ops = ShardedOps(make_mesh(d, "cuda"))
    for step, v, a, b in _fold_cases(d, 12, cuda):
        want = fri.fold_step(v, step, a, b)
        before = fri_kernels.KERNEL.launches
        got = ops.fold_step(v, step, a, b)
        sharded = (v.shape[1] >> step.folds) >= 2 * d
        assert fri_kernels.KERNEL.launches - before == (d if sharded else 1)
        assert torch.equal(got.full() if sharded else got, want), step


def test_fold_kernel_refusals(cuda):
    from stwo_brainfuck_tpu_torch.core import fri
    from stwo_brainfuck_tpu_torch.ops import fri_kernels

    step, v, a, b = _fold_cases(5, 8, cuda)[-1]
    with pytest.raises(TypeError):
        fri_kernels.KERNEL.fold(v.to(torch.int64), step, a, b)
    with pytest.raises(ValueError):
        fri_kernels.KERNEL.fold(v[:, :-1], step, a, b)
    with pytest.raises(ValueError):
        fri_kernels.KERNEL.fold(v, step, a, b.cpu())
    with pytest.raises(ValueError):
        fri_kernels.KERNEL.fold(v, dataclasses.replace(step, folds=0), None, None)


def test_fib19_io_prove_makes_one_oods_launch_and_one_fold_launch_a_layer(cuda):
    from stwo_brainfuck_tpu_torch.core import fri, poly
    from stwo_brainfuck_tpu_torch.ops import fri_kernels, oods_kernels

    with open(chip_smoke.os.path.join(chip_smoke.ROOT, "programs", "fib19_io.bf")) as f:
        m = create_test_machine(compile_program(f.read()), chip_smoke.FIB_INPUT)
    m.execute()
    oods, folds = oods_kernels.KERNEL.launches, fri_kernels.KERNEL.launches
    plain = (poly.PLAIN_CUDA_CALLS, fri.PLAIN_CUDA_CALLS)
    with tracing.record(0) as rec:
        proof = air.prove_brainfuck(m, device=cuda)
    assert oods_kernels.KERNEL.launches - oods == 1 and rec.counters.get("sync.oods") == 1
    assert fri_kernels.KERNEL.launches - folds == len(proof["fri"]["layer_roots"]) + 1
    assert (poly.PLAIN_CUDA_CALLS, fri.PLAIN_CUDA_CALLS) == plain
    assert chip_smoke.proof_sha256(proof) == chip_smoke.REFERENCE_SHA256["fib19_io"]


@pytest.mark.parametrize("stage", ["evaluate_lower", "evaluate_upper", "interpolate_lower",
                                   "interpolate_lower_scaled", "interpolate_upper", "add"])
def test_mesh_stage_kernel_matches_the_plain_path_on_the_card(cuda, stage):
    """The mesh-stage kernel on a (4, 2^22) shard, in place and into another
    buffer, against the plain path (the same values on the CPU), with 0
    and p - 1 among the inputs; a column view at an odd offset takes the
    scalar loop."""
    from stwo_brainfuck_tpu_torch.ops import mesh_kernels

    rng = np.random.default_rng(len(stage))
    x = rng.integers(0, P, (4, 1 << 22), dtype=np.int64)
    y = rng.integers(0, P, (4, 1 << 22), dtype=np.int64)
    x[0, :4], y[0, :4] = [0, P - 1, P - 1, 0], [P - 1, P - 1, 0, 0]
    x, y = (torch.as_tensor(v.astype(np.int32)) for v in (x, y))
    t = int(rng.integers(1, P))
    kind, _, how = stage.partition("_")

    def run(a, b, out=None):
        if kind == "add":
            return mesh_kernels.add_into(a, b)
        upper = how == "upper"
        if kind == "evaluate":
            return mesh_kernels.evaluate_cross(a, b, t, upper, out=out)
        return mesh_kernels.interpolate_cross(a, b, t, upper, out=out,
                                              scale=fft.inv_pow2(30) if how != "lower" else 1)

    want = run(x.clone(), y)
    before = mesh_kernels.KERNEL.launches
    got = x.to(cuda)
    assert run(got, y.to(cuda)) is got
    assert torch.equal(got.cpu(), want)
    if kind != "add":
        out = torch.empty_like(got)
        run(x.to(cuda), y.to(cuda), out)
        assert torch.equal(out.cpu(), want)
    odd = x.to(cuda).reshape(-1)[1:1 + (1 << 20)].clone()[:-1]
    odd_view = torch.cat([torch.zeros(1, dtype=torch.int32, device=cuda), odd])[1:]
    assert odd_view.data_ptr() % 16 != 0
    partner = y.reshape(-1)[:odd.numel()]
    want_odd = run(odd.cpu().clone(), partner.clone())
    run(odd_view, partner.to(cuda))
    assert torch.equal(odd_view.cpu(), want_odd)
    assert mesh_kernels.KERNEL.launches - before == (2 if kind == "add" else 3)
    assert mesh_kernels.PLAIN_CUDA_CALLS == 0
