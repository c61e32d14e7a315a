"""The port's circle FFT vs the JAX package's: the plain staged torch
version against the staged XLA path and the Pallas kernels in interpret
mode (including the forced two-pass split), the closed forms and the
permutations, and a CPU emulation of the CUDA kernel's schedule (same tile
and global passes, same index arithmetic) against the plain version.
Bit-identical throughout."""

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


@pytest.mark.parametrize("n", (1, 2) + SIZES + (16, 20))
def test_kernel_schedule_emulation_matches_plain(n):
    """Every pass of the kernel's plan with its block/tile/pair index
    arithmetic: one tile pass up to 2^12, then one global pass (n = 13,
    16) and two (n = 20)."""
    x = convert.to_torch(_vals(40 + n, (3 if n < 20 else 1, 1 << n)))
    np.testing.assert_array_equal(
        convert.to_numpy(circle_fft.emulate(x, n, False)),
        convert.to_numpy(tfft.evaluate_plain(x, n)))
    np.testing.assert_array_equal(
        convert.to_numpy(circle_fft.emulate(x, n, True)),
        convert.to_numpy(tfft.interpolate_plain(x, n)))


def test_pass_plan_covers_every_stage_once():
    for n in range(1, 27):
        for inverse in (False, True):
            plan = circle_fft.pass_plan(n, inverse)
            stages = [l0 + s for l0, cnt, _ in plan for s in range(cnt)]
            assert sorted(stages) == list(range(n))
            assert all(cnt + w <= circle_fft.TILE_LOG for _, cnt, w in plan)
            order = [l0 for l0, _, _ in plan]
            assert order == sorted(order, reverse=not inverse)
    assert len(circle_fft.pass_plan(20, False)) == 3
    assert len(circle_fft.pass_plan(24, False)) == 3


def test_kernel_wrapper_checks_its_inputs():
    x = torch.zeros(3, 16, dtype=torch.int32)
    with pytest.raises(TypeError):
        circle_fft.KERNEL.run(x.to(torch.int64), 4, False)
    with pytest.raises(ValueError):
        circle_fft.KERNEL.run(x, 5, False)
    with pytest.raises(ValueError):
        circle_fft.KERNEL.run(x, 4, False)  # a CPU tensor never reaches the kernel
    with pytest.raises(ValueError):
        circle_fft.evaluate(x.to("meta"), 4)


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
