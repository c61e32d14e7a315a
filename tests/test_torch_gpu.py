"""Tests that need a CUDA GPU (marker `gpu`; skipped without one). They
import no jax, so on a machine with a card and no jax they run with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from stwo_brainfuck_tpu_torch import air
from stwo_brainfuck_tpu_torch.components import device_build, tables
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES, ELEMENT_SIZES
from stwo_brainfuck_tpu_torch.core import blake2s, channel, fft, merkle, quotients
from stwo_brainfuck_tpu_torch.core.circle import point_from_t
from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig, shifted_point
from stwo_brainfuck_tpu_torch.framework import component as framework
from stwo_brainfuck_tpu_torch.ops import (blake2s_kernels, circle_fft, constraint_kernels,
                                           m31_kernels, quotient_kernels)
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
    return cols, [quotients._group_constants(m, alpha)
                  for m in quotients._group_claims(claims).values()]


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
            es, ec = constraint_kernels.emulate_scan(total)
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
    out = (ctypes.c_int * 5)()
    for log_n in range(2, 31):
        assert lib.logup_scan_geometry(log_n, ctypes.addressof(out)) == 0
        assert tuple(out) == constraint_kernels.scan_geometry(log_n)
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


@pytest.mark.parametrize("blow", [1, 4])
@pytest.mark.parametrize("log", [5, 16])
@pytest.mark.parametrize("cls", COMPONENT_CLASSES, ids=lambda c: c.name)
def test_constraint_kernels_match_plain_on_the_card(cuda, cls, log, blow):
    comp, rows, felt, els, m = _constraint_case(cls, log, blow, log * 10 + blow, cuda)
    main = dict(zip(comp.columns, rows(len(comp.columns), m)))
    inter = rows(4 * (comp.relation_count() + 1), m)
    isf = rows(1, m)[0]
    rot = fft.rotation_index(log, blow, cuda)
    acc = torch.stack(rows(4, m))
    before = acc.clone()
    claimed, alpha = felt(), felt()
    launches, plain = dict(constraint_kernels.KERNELS.launches), framework.PLAIN_CUDA_CALLS
    out, nxt = framework.composition_accumulate(comp, main, inter, inter[-4:], rot, isf, claimed,
                                                els, alpha, 9, blow, acc)
    assert out is acc and nxt == 9 + comp.constraint_count()
    assert framework.PLAIN_CUDA_CALLS == plain
    want, _ = framework.composition_plain(comp, main, inter, inter[-4:], rot, isf, claimed, els,
                                          alpha, 9, blow)
    assert torch.equal(acc.to(torch.int64), (before.to(torch.int64) + want) % P)
    # logup on the trace domain's rows
    n = 1 << log
    lmain = {k: v[:n].contiguous() for k, v in main.items()}
    q, total = framework.logup_fractions(comp, lmain, isf[:n].contiguous(), els)
    wq, wtotal = framework.logup_fractions_plain(comp, lmain, isf[:n].contiguous(), els)
    assert torch.equal(q, wq) and torch.equal(total.to(torch.int64), wtotal)
    assert constraint_kernels.KERNELS.launches == {
        **launches, "composition": launches["composition"] + 1, "logup": launches["logup"] + 1}


def test_constraint_kernel_chunks_and_refusals_on_the_card(cuda):
    cls = COMPONENT_CLASSES[3]  # processor: three relations
    comp, rows, felt, els, m = _constraint_case(cls, 10, 2, 7, cuda)
    main = dict(zip(comp.columns, rows(len(comp.columns), m)))
    inter = rows(4 * (comp.relation_count() + 1), m)
    isf = rows(1, m)[0]
    rot = fft.rotation_index(10, 2, cuda)
    args = (felt(), els, felt(), 0, 2)
    whole, _ = framework.composition_accumulate(comp, main, inter, inter[-4:], rot, isf, *args,
                                                None)
    s_prev = torch.stack(inter[-4:])[:, rot.to(torch.int64)]
    c = m // 4
    for i in range(4):
        sl = slice(i * c, (i + 1) * c)
        part, _ = framework.composition_accumulate(
            comp, {k: v[sl] for k, v in main.items()}, [r[sl] for r in inter],
            [r[sl] for r in s_prev], None, isf[sl], *args, None, offset=i * c)
        assert torch.equal(part, whole[:, sl])
    with pytest.raises(TypeError):
        framework.composition_accumulate(comp, {**main, "clk": main["clk"].to(torch.int64)},
                                         inter, inter[-4:], rot, isf, *args, None)
    with pytest.raises(ValueError):
        framework.composition_accumulate(comp, main, inter, inter[-4:], rot, isf, *args, None,
                                         offset=1)
    with pytest.raises(ValueError):
        constraint_kernels.KERNELS.logup(comp, {**main, "clk": main["clk"][::2]}, isf, els)


def test_fib19_io_prove_launches_each_constraint_kernel_once_a_component(cuda):
    with open(chip_smoke.os.path.join(chip_smoke.ROOT, "programs", "fib19_io.bf")) as f:
        m = create_test_machine(compile_program(f.read()), chip_smoke.FIB_INPUT)
    m.execute()
    launches, plain = dict(constraint_kernels.KERNELS.launches), framework.PLAIN_CUDA_CALLS
    proof = air.prove_brainfuck(m, device=cuda)
    assert framework.PLAIN_CUDA_CALLS == plain
    for family in constraint_kernels.FAMILIES:
        assert constraint_kernels.KERNELS.launches[family] - launches[family] == \
            len(COMPONENT_CLASSES)
    assert chip_smoke.proof_sha256(proof) == chip_smoke.REFERENCE_SHA256["fib19_io"]
