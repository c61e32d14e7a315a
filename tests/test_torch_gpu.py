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
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES
from stwo_brainfuck_tpu_torch.core import blake2s, channel, fft, merkle
from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig
from stwo_brainfuck_tpu_torch.ops import blake2s_kernels, circle_fft, m31_kernels
from stwo_brainfuck_tpu_torch.parallel import fft_sharded
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
    proof = air.prove_brainfuck(m, device=cuda)
    assert fft.PLAIN_CUDA_CALLS == 0
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
    proof = air.prove_brainfuck(m, device=cuda, mesh=make_mesh(8, cuda))
    assert fft.PLAIN_CUDA_CALLS == 0
    assert circle_fft.KERNEL.launches > before
    assert chip_smoke.proof_sha256(proof) == chip_smoke.REFERENCE_SHA256["small"]
    air.verify_brainfuck(proof, device=cuda)


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


@pytest.mark.parametrize("k_top, k_bottom", [(0, 0), (3, 0), (10, 0), (10, 4), (6, 6)])
def test_blake2s_tail_matches_plain_on_the_card(cuda, k_top, k_bottom):
    kids = _words(np.random.default_rng(k_top), (8, 2 << k_top), cuda)
    got = blake2s_kernels.KERNELS.tail(kids, k_top, k_bottom)
    want = blake2s_kernels.tail_plain(kids, k_top, k_bottom)
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), f"level {k}"


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
    for kind in ("level", "tail"):
        assert blake2s_kernels.KERNELS.launches[kind] - launches[kind] == sum(
            s[0] == kind for s in plan)
    assert blake2s.PLAIN_CUDA_CALLS == calls
    assert got.root == want.root
    for k in want.layers:
        assert torch.equal(got.layers[k].cpu(), want.layers[k]), f"level {k}"


@pytest.mark.parametrize("pow_bits", [8, 14, 16, 20])
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
