"""The port's circle FFT vs the JAX package's: the plain staged torch
version against the staged XLA path and the Pallas kernels in interpret
mode (including the forced two-pass split), the closed forms and the
permutations, and a CPU replay of the CUDA kernel's launches (same passes,
block geometry, thread registers, swizzled shared memory, twiddle staging
and 32-bit arithmetic) for evaluate, interpolate and the fused extend,
against the plain version and the JAX package. Bit-identical throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.core import fft as jfft
from stwo_brainfuck_tpu.ops import fft_pallas
from stwo_brainfuck_tpu_torch import convert
from stwo_brainfuck_tpu_torch.core import fft as tfft
from stwo_brainfuck_tpu_torch.ops import circle_fft

torch.set_num_threads(1)
P = 2**31 - 1
SIZES = (4, 5, 11, 12, 13)


def _vals(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint32)


@pytest.mark.parametrize("n", SIZES)
def test_plain_fft_matches_jax_staged(n):
    for shape in ((3, 1 << n), (1 << n,)):
        x = _vals(n, shape)
        np.testing.assert_array_equal(
            convert.to_numpy(tfft.evaluate(convert.to_torch(x), n)),
            np.asarray(jfft._evaluate_jit(jnp.asarray(x), jfft._device_twiddles(n)[0], n)))
        np.testing.assert_array_equal(
            convert.to_numpy(tfft.interpolate(convert.to_torch(x), n)),
            np.asarray(jfft._interpolate_jit(jnp.asarray(x), jfft._device_twiddles(n)[1], n)))


@pytest.mark.parametrize("n", (11, 12))
def test_plain_fft_matches_pallas_interpret(n):
    x = _vals(20 + n, (2, 1 << n))
    xt = convert.to_torch(x)
    np.testing.assert_array_equal(convert.to_numpy(tfft.evaluate(xt, n)),
                                  np.asarray(fft_pallas.evaluate(jnp.asarray(x), n, interpret=True)))
    np.testing.assert_array_equal(convert.to_numpy(tfft.interpolate(xt, n)),
                                  np.asarray(fft_pallas.interpolate(jnp.asarray(x), n, interpret=True)))
    c, e = fft_pallas.extend_with_coeffs(jnp.asarray(x), n, 1, interpret=True)
    ct, et = tfft.extend_with_coeffs(xt, n, 1)
    np.testing.assert_array_equal(convert.to_numpy(ct), np.asarray(c))
    np.testing.assert_array_equal(convert.to_numpy(et), np.asarray(e))


def test_plain_fft_matches_pallas_two_pass_split(monkeypatch):
    """The Pallas pass-1/pass-2 split forced at a small size."""
    monkeypatch.setattr(fft_pallas, "_MAX_LOG_A2", 3)
    fft_pallas._tables.cache_clear()
    saved = dict(fft_pallas._DEV_TABLES)
    fft_pallas._DEV_TABLES.clear()
    try:
        n = 12
        assert fft_pallas._plan(n)[2] == 2
        x = _vals(31, (2, 1 << n))
        xt = convert.to_torch(x)
        np.testing.assert_array_equal(
            convert.to_numpy(circle_fft.emulate(xt, n, False)),
            np.asarray(fft_pallas.evaluate(jnp.asarray(x), n, interpret=True)))
        np.testing.assert_array_equal(
            convert.to_numpy(circle_fft.emulate(xt, n, True)),
            np.asarray(fft_pallas.interpolate(jnp.asarray(x), n, interpret=True)))
    finally:
        fft_pallas._tables.cache_clear()
        fft_pallas._DEV_TABLES.clear()
        fft_pallas._DEV_TABLES.update(saved)


EMU_SIZES = (1, 2, 4, 5, 11, 12, 13, 14, 16, 18)


@pytest.mark.parametrize("cols", (1, 3))
@pytest.mark.parametrize("n", EMU_SIZES)
def test_kernel_schedule_emulation_matches_plain(n, cols):
    """Every launch of the kernel's plan replayed on the CPU (block and row
    geometry, each thread's registers, swizzled shared memory, staged
    twiddles, 32-bit arithmetic): one tile pass up to 2^13, then one
    global pass."""
    x = convert.to_torch(_vals(40 + n, (cols, 1 << n)))
    np.testing.assert_array_equal(
        convert.to_numpy(circle_fft.emulate(x, n, False)),
        convert.to_numpy(tfft.evaluate_plain(x, n)))
    np.testing.assert_array_equal(
        convert.to_numpy(circle_fft.emulate(x, n, True)),
        convert.to_numpy(tfft.interpolate_plain(x, n)))


@pytest.mark.parametrize("blowup", (1, 2, 3, 4))
@pytest.mark.parametrize("n", (5, 13, 15))
def test_fused_extend_emulation_matches_plain(n, blowup):
    """The fused extend (one launch up to 2^13; else inverse tile pass,
    fused global pass, forward tile pass on the copies) against the plain
    interpolate -> zero-pad -> evaluate that a CPU tensor takes."""
    x = convert.to_torch(_vals(60 + n + blowup, (2, 1 << n)))
    plan = circle_fft.launch_plan("extend", n, 2, blowup)
    assert len(plan) == (1 if n <= circle_fft.TILE_LOG else 3)
    for g, w in zip(circle_fft.emulate_extend(x, n, blowup),
                    tfft.extend_with_coeffs(x, n, blowup)):
        np.testing.assert_array_equal(convert.to_numpy(g), convert.to_numpy(w))


def test_emulation_with_rows_shared_out(monkeypatch):
    """Blocks that take several rows, and a forward pass whose blocks
    interleave the extend's copies: every row is taken once."""
    monkeypatch.setattr(circle_fft, "TARGET_BLOCKS", 4)
    n, blowup = 14, 2
    x = convert.to_torch(_vals(70, (5, 1 << n)))
    plan = circle_fft.launch_plan("extend", n, 5, blowup)
    assert all(a.rows_per_block > 1 for a in plan)
    for a in plan:
        rows = [r for r, _ in circle_fft._block_rows(a)]
        total = a.rows << (a.copies_log if a.mode == circle_fft.MODE_FORWARD else 0)
        assert sorted(rows) == list(range(total))
    for g, w in zip(circle_fft.emulate_extend(x, n, blowup), tfft.extend_with_coeffs(x, n, blowup)):
        np.testing.assert_array_equal(convert.to_numpy(g), convert.to_numpy(w))
    np.testing.assert_array_equal(convert.to_numpy(circle_fft.emulate(x, n, False)),
                                  convert.to_numpy(tfft.evaluate_plain(x, n)))


@pytest.mark.parametrize("n", (13, 14))
def test_emulation_edge_values(n):
    """Inputs 0, 1, P - 1 and 2^16 throughout a tile (and the extend's
    copies): sums that reach P and products of P - 1 stay exact."""
    edges = np.array([0, 1, P - 1, 1 << 16], dtype=np.uint32)
    x = convert.to_torch(np.stack([np.tile(edges, (1 << n) // 4), np.repeat(edges, (1 << n) // 4)]))
    for inverse, plain in ((False, tfft.evaluate_plain), (True, tfft.interpolate_plain)):
        np.testing.assert_array_equal(convert.to_numpy(circle_fft.emulate(x, n, inverse)),
                                      convert.to_numpy(plain(x, n)))
    for g, w in zip(circle_fft.emulate_extend(x, n, 1), tfft.extend_with_coeffs(x, n, 1)):
        np.testing.assert_array_equal(convert.to_numpy(g), convert.to_numpy(w))


@pytest.mark.parametrize("blowup", (1, 2, 4))
def test_fused_extend_emulation_matches_jax_extend(blowup):
    n = 6
    x = _vals(80 + blowup, (3, 1 << n))
    c, e = jfft._extend_jit(jnp.asarray(x), jfft._device_twiddles(n)[1],
                            jfft._device_twiddles(n + blowup)[0], n, blowup)
    ct, et = circle_fft.emulate_extend(convert.to_torch(x), n, blowup)
    np.testing.assert_array_equal(convert.to_numpy(ct), np.asarray(c))
    np.testing.assert_array_equal(convert.to_numpy(et), np.asarray(e))


@pytest.mark.parametrize("n", (11, 12))
def test_fused_extend_emulation_matches_pallas_interpret(n):
    x = _vals(90 + n, (2, 1 << n))
    c, e = fft_pallas.extend_with_coeffs(jnp.asarray(x), n, 1, interpret=True)
    ct, et = circle_fft.emulate_extend(convert.to_torch(x), n, 1)
    np.testing.assert_array_equal(convert.to_numpy(ct), np.asarray(c))
    np.testing.assert_array_equal(convert.to_numpy(et), np.asarray(e))


def test_pass_plan_covers_every_stage_once():
    """At most two passes for every n <= 24, every stage once, every
    launch's tile, threads and shared memory within the card's limits."""
    for n in range(1, 27):
        for inverse in (False, True):
            plan = circle_fft.pass_plan(n, inverse)
            stages = [l0 + s for l0, cnt, _ in plan for s in range(cnt)]
            assert sorted(stages) == list(range(n))
            order = [l0 for l0, _, _ in plan]
            assert order == sorted(order, reverse=not inverse)
            if n <= 24:
                assert len(plan) <= 2
        ops = [("evaluate", 0), ("interpolate", 0)] + [("extend", b) for b in (1, 4) if n + b <= 30]
        for op, blowup in ops:
            for a in circle_fft.launch_plan(op, n, 40, blowup):
                assert circle_fft.smem_bytes(a.mode, a.s_count, a.w_log) <= circle_fft.SMEM_LIMIT
                assert a.tile_log - a.radix <= circle_fft.THREADS_LOG and 1 <= a.radix <= 5
                assert a.w_log == 0 if a.l0 == 0 else circle_fft.MIN_W_LOG <= a.w_log <= a.l0
                assert a.grid()[1] <= circle_fft.MAX_GRID_Y


def test_shared_memory_exchanges_have_few_bank_conflicts():
    """The swizzle is a bijection of the tile that keeps 16-byte chunks
    whole, and no warp's access of any group of any plan up to 2^24 hits
    one bank at more than two addresses (4-byte accesses) or one bank group
    twice in a quarter warp (16-byte accesses)."""
    worst = 1
    seen = set()
    for n in range(1, 25):
        for l0, s_count, w_log in circle_fft.pass_plan(n, False):
            tile_log = s_count + w_log
            if (tile_log, s_count, w_log) in seen:
                continue
            seen.add((tile_log, s_count, w_log))
            e = torch.arange(1 << tile_log)
            words = circle_fft.swizzle(e)
            assert sorted(words.tolist()) == e.tolist()
            assert torch.equal(words & 3, e & 3)
            r = circle_fft.radix(tile_log)
            for s0, g in circle_fft.tile_groups(s_count, r):
                el = circle_fft.thread_elements(tile_log, w_log, r, s0, g)
                assert sorted(el.reshape(-1).tolist()) == e.tolist()
                addr = circle_fft.swizzle(el)
                vector = r >= 2 and (r - g >= 2 or w_log + s0 == r - g)
                for w0 in range(0, addr.shape[0], 32):
                    warp = addr[w0:w0 + 32]
                    for k in range(0, 1 << r, 4 if vector else 1):
                        if vector:
                            for q in range(0, warp.shape[0], 8):
                                grp = ((warp[q:q + 8, k] >> 2) & 7).tolist()
                                worst = max(worst, max(grp.count(b) for b in grp))
                        else:
                            col = warp[:, k].tolist()
                            banks = {}
                            for a in col:
                                banks.setdefault(a & 31, set()).add(a)
                            worst = max(worst, max(len(v) for v in banks.values()))
    assert worst <= 2


def test_kernel_wrapper_checks_its_inputs():
    x = torch.zeros(3, 16, dtype=torch.int32)
    with pytest.raises(TypeError):
        circle_fft.KERNEL.run("evaluate", x.to(torch.int64), 4)
    with pytest.raises(ValueError):
        circle_fft.KERNEL.run("evaluate", x, 5)
    with pytest.raises(ValueError):
        circle_fft.KERNEL.run("evaluate", x, 4)  # a CPU tensor never reaches the kernel
    with pytest.raises(ValueError):
        circle_fft.KERNEL.run("extend", x, 4, 0)
    with pytest.raises(ValueError):
        circle_fft.evaluate(x.to("meta"), 4)
    with pytest.raises(ValueError):
        circle_fft.extend(x, 4, 27)


def test_twiddles_match_jax():
    for n in (1, 3, 8, 13):
        tj = jfft.get_twiddles(n)
        fwd = tfft.get_twiddles(n, False, "cpu")
        inv = tfft.get_twiddles(n, True, "cpu")
        assert len(fwd) == len(inv) == n
        for L in range(n):
            np.testing.assert_array_equal(fwd[L].numpy(), tj.fwd[L].astype(np.int64))
            np.testing.assert_array_equal(inv[L].numpy(), tj.inv[L].astype(np.int64))


def test_extend_is_first_and_permutations_match_jax():
    n = 6
    x = _vals(50, (4, 1 << n))
    c, e = jfft._extend_jit(jnp.asarray(x), jfft._device_twiddles(n)[1],
                            jfft._device_twiddles(n + 1)[0], n, 1)
    ct, et = tfft.extend_with_coeffs(convert.to_torch(x), n, 1)
    np.testing.assert_array_equal(convert.to_numpy(ct), np.asarray(c))
    np.testing.assert_array_equal(convert.to_numpy(et), np.asarray(e))
    for log in (2, 4, 7):
        np.testing.assert_array_equal(convert.to_numpy(tfft.is_first_coeffs(log, "cpu")),
                                      np.asarray(jfft.is_first_coeffs(log)))
        for blow in (1, 2):
            np.testing.assert_array_equal(
                convert.to_numpy(tfft.is_first_extended(log, log + blow, "cpu")),
                np.asarray(jfft.is_first_extended(log, log + blow)))
        np.testing.assert_array_equal(tfft.coset_order_permutation(log, "cpu").numpy(),
                                      jfft.coset_order_permutation(log).astype(np.int64))
        for blow, steps in ((1, 1), (2, 3)):
            np.testing.assert_array_equal(
                tfft.rotation_permutation(log, blow, steps, "cpu").numpy(),
                jfft.rotation_permutation(log, blow, steps).astype(np.int64))
