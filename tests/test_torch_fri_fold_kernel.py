"""The FRI fold kernel's emulation (ops/fri_kernels.emulate: a thread's
outputs, the twiddles it reads from the circle FFT's doubled tables at the
step's and the chunk's offsets, their batched inversion, the folds and the
injections) and the plain fold step against the JAX package's
stwo_brainfuck_tpu/core/fri.py _fold_jit, _fold2_jit and _fold_add_jit,
bit for bit, in every mode of core/fri.FoldStep, whole and as a mesh
shard's chunk; the twiddle tables against fri._fold_itw; fri_commit with
every step emulated against the JAX package's fri_commit; and a small
prove with both new kernels emulated, whose proof is the JAX package's.
The wrapper's refusals (it checks before it loads the library)."""

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.core import fri as jfri
from stwo_brainfuck_tpu.core.channel import Blake2sChannel as JChannel
from stwo_brainfuck_tpu_torch import air, bench, convert, tracing
from stwo_brainfuck_tpu_torch.core import fri as tfri
from stwo_brainfuck_tpu_torch.core import poly as tpoly
from stwo_brainfuck_tpu_torch.core.channel import Blake2sChannel as TChannel
from stwo_brainfuck_tpu_torch.ops import fri_kernels, oods_kernels
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine

torch.set_num_threads(1)
P = 2**31 - 1
TOP = 14  # the FFT table the line twiddles are read from


def _felt(rng):
    return tuple(int(v) for v in rng.integers(0, P, 4))


def _b(beta):
    return jnp.asarray(np.array(beta, np.uint32))


def _jax_step(step, values, a, b):
    """The step through the JAX package's jitted folds (host uint32 arrays)."""
    c = lambda log: jnp.asarray(jfri._circle_fold_itw(log))  # noqa: E731
    ln = lambda log: jnp.asarray(jfri._line_fold_itw(log))  # noqa: E731
    cur = jnp.asarray(values)
    if step.folds == 1:
        cur = jfri._fold_jit(cur, (c if step.circle else ln)(step.level), _b(step.beta))
    elif step.folds == 2 and a is None:
        cur = jfri._fold2_jit(cur, ln(step.level), ln(step.level - 1), _b(step.beta),
                              _b(step.beta2))
    elif step.folds == 2:
        cur = jfri._fold_jit(cur, ln(step.level), _b(step.beta))
        cur = jfri._fold_add_jit(jnp.asarray(a), c(step.level), _b(step.beta0), cur)
        cur = jfri._fold_jit(cur, ln(step.level - 1), _b(step.beta2))
    if b is not None:
        cur = jfri._fold_add_jit(jnp.asarray(b), c(step.out_level + 1), _b(step.beta0), cur)
    return np.asarray(cur)


def _cases(seed):
    """(step, values, inject_a, inject_b) host arrays for every mode."""
    rng = np.random.default_rng(seed)

    def arr(n):
        return rng.integers(0, P, (4, n), dtype=np.uint32)

    b, b2, b0 = _felt(rng), _felt(rng), _felt(rng)
    out = [(tfri.FoldStep(TOP, 1, True, b0, b0, b0, TOP), arr(1 << TOP), None, None),
           (tfri.FoldStep(5, 0, False, b, b2, b0, TOP), arr(1 << 5), None, arr(1 << 6))]
    for level in (11, 4, 2):
        for folds in (1, 2):
            if level - folds < 1:
                continue
            n = 1 << (level - folds)
            for with_a in ((False, True) if folds == 2 else (False,)):
                for with_b in (False, True):
                    out.append((tfri.FoldStep(level, folds, False, b, b2, b0, TOP),
                                arr(1 << level), arr(4 * n) if with_a else None,
                                arr(2 * n) if with_b else None))
    return out


def _t(x):
    return None if x is None else convert.to_torch(x)


@pytest.mark.parametrize("k", range(16))
def test_fold_modes_match_jax(k):
    step, v, a, b = _cases(k)[k]
    want = _jax_step(step, v, a, b)
    plain = tfri.fold_step(_t(v), step, _t(a), _t(b))
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(convert.to_numpy(plain), want)
    got = fri_kernels.emulate(_t(v), step, _t(a), _t(b))
    np.testing.assert_array_equal(convert.to_numpy(got), want)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("k", [0, 1, 4, 8, 9])
def test_shard_chunks_match_jax(k, shards):
    """A shard's launch: its chunk of the output at the chunk's offset, the
    twiddles read at the offset in the tables, from the chunks of the
    values and the injected inputs."""
    step, v, a, b = _cases(k + 20)[k]
    want = _jax_step(step, v, a, b)
    n = want.shape[1]
    c = n // shards
    width = 1 << step.folds
    for i in range(shards):
        part = lambda x, w: None if x is None else _t(x[:, i * c * w:(i + 1) * c * w])  # noqa
        got = fri_kernels.emulate(part(v, width), step, part(a, 4), part(b, 2), offset=i * c)
        np.testing.assert_array_equal(convert.to_numpy(got), want[:, i * c:(i + 1) * c])
        plain = tfri.fold_step(part(v, width), step, part(a, 4), part(b, 2), offset=i * c)
        np.testing.assert_array_equal(convert.to_numpy(plain), want[:, i * c:(i + 1) * c])


@pytest.mark.parametrize("top", [3, 9, 14])
def test_fold_twiddles_are_the_fft_tables_inverted(top):
    """The circle fold's twiddles are stage 0 of the FFT table of its size;
    every line level's a stage of the table of size 2^top; inverted, both
    are fri._fold_itw (and the JAX package's tables)."""
    def inverted(table, start, count):
        t = table.to(torch.int64)[start:start + count] & 0xFFFFFFFF
        return fri_kernels.batch_inv(torch.where(t >= P, t - P, t)[None])[0]

    for log in range(1, top):
        table, start = tfri.fold_twiddles("l", log, top, "cpu")
        want = tfri._fold_itw("l", log, "cpu")
        np.testing.assert_array_equal(inverted(table, start, 1 << (log - 1)).numpy(),
                                      want.numpy())
        np.testing.assert_array_equal(want.numpy().astype(np.uint32), jfri._line_fold_itw(log))
    for log in range(2, top + 1):
        table, start = tfri.fold_twiddles("c", log, top, "cpu")
        want = tfri._fold_itw("c", log, "cpu")
        np.testing.assert_array_equal(inverted(table, start, 1 << (log - 1)).numpy(),
                                      want.numpy())
        np.testing.assert_array_equal(want.numpy().astype(np.uint32),
                                      jfri._circle_fold_itw(log))
    with pytest.raises(ValueError):
        tfri.fold_twiddles("l", top, top, "cpu")


def _low_degree(rng, log):
    """A (4, 2^log) evaluation of a polynomial of degree < 2^(log - 1)
    (the JAX package's FFT)."""
    from stwo_brainfuck_tpu.core import fft as jfft

    coeffs = np.zeros((4, 1 << log), np.uint32)
    coeffs[:, :1 << (log - 1)] = rng.integers(0, P, (4, 1 << (log - 1)), dtype=np.uint32)
    return np.asarray(jfft.evaluate(jnp.asarray(coeffs), log))


@pytest.mark.parametrize("logs", [[7], [9, 8, 6, 5], [10, 9, 4, 3]])
def test_fri_commit_with_emulated_steps_matches_jax(logs):
    """fri_commit with every fold step through the kernel's emulation: one
    step a committed layer plus the last, and the JAX package's layer roots,
    layers, last value and transcript."""
    rng = np.random.default_rng(sum(logs))
    inputs = {lg: _low_degree(rng, lg) for lg in logs}
    jch, tch = JChannel(), TChannel()
    jp = jfri.fri_commit({k: jnp.asarray(v) for k, v in inputs.items()}, jch)
    steps = []

    def emulated(values, step, inject_a=None, inject_b=None, offset=0):
        steps.append(step)
        return fri_kernels.emulate(values, step, inject_a, inject_b, offset)

    with mock.patch.object(tfri, "fold_step", emulated):
        tp = tfri.fri_commit({k: convert.to_torch(v) for k, v in inputs.items()}, tch)
    assert tp.proof.layer_roots == jp.proof.layer_roots
    assert tp.proof.last_layer_value == tuple(int(x) for x in jp.proof.last_layer_value)
    assert tch.digest == jch.digest
    assert len(steps) == len(tp.layers) + 1
    for tl, jl in zip(tp.layer_evals, jp.layer_evals):
        assert tl.dtype == torch.int32
        np.testing.assert_array_equal(convert.to_numpy(tl), np.asarray(jl))


def test_small_prove_with_emulated_kernels_is_the_jax_proof():
    """The small program proved on the CPU with the OODS launch and every
    fold step through the kernels' emulations: one OODS launch and pull,
    one fold step a FRI layer plus the last, and the JAX package's proof
    (its recorded sha256)."""
    machine = create_test_machine(compile_program("+++>,<[>+.<-]"), b"\x01")
    machine.execute()
    calls = {"oods": 0, "fold": 0}

    def sample(groups, shard=0):
        calls["oods"] += 1
        return oods_kernels.emulate(groups, shard)

    def fold(values, step, inject_a=None, inject_b=None, offset=0):
        calls["fold"] += 1
        return fri_kernels.emulate(values, step, inject_a, inject_b, offset)

    with mock.patch.object(tpoly, "sample_groups", sample), \
            mock.patch.object(tfri, "fold_step", fold), tracing.record(0) as rec:
        proof = air.prove_brainfuck(machine, device="cpu")
    assert calls["oods"] == 1 and rec.counters.get("sync.oods") == 1
    assert calls["fold"] == len(proof["fri"]["layer_roots"]) + 1
    assert bench.proof_sha256(proof) == bench.REFERENCE_SHA256["small"]
    air.verify_brainfuck(proof, device="cpu")


def test_wrapper_refuses_before_loading_the_library():
    step, v, a, b = _cases(3)[3]
    kernel = fri_kernels.FoldKernel()
    with pytest.raises(ValueError, match="CUDA"):
        kernel.fold(_t(v), step, _t(a), _t(b))
    with pytest.raises(TypeError):
        kernel.fold(_t(v).to(torch.int64), step, _t(a), _t(b))
    with pytest.raises(ValueError):
        kernel.fold(_t(v)[:, :-2], step, _t(a), _t(b))
    with pytest.raises(ValueError):
        kernel.fold(_t(v), dataclasses.replace(step, folds=0), None, None)
    with pytest.raises(ValueError):
        kernel.fold(_t(v), dataclasses.replace(step, folds=1), _t(a), None)
    assert kernel.lib._lib is None and kernel.launches == 0


@pytest.mark.parametrize("folds", [0, 1, 2])
def test_wrapper_refuses_outputs_past_32_bit_indices(folds):
    """The kernel indexes in 32 bits: the largest word it reads is
    4 n - 1 with two folds, else 2 n - 1 (the pairs, inject_b). The wrapper
    refuses one output more than that before it loads the library (meta
    tensors: nothing is allocated)."""
    kernel = fri_kernels.FoldKernel()
    rng = np.random.default_rng(folds)
    beta = _felt(rng)
    step = tfri.FoldStep(33, folds, False, beta, beta, beta, 33)
    most = 1 << (32 - max(folds, 1))

    def arrays(n):
        meta = lambda m: torch.empty((4, m), dtype=torch.int32, device="meta")  # noqa: E731
        return meta(n << folds), None, meta(2 * n)

    with pytest.raises(ValueError, match="32 bits"):
        kernel.fold(*arrays(most + 1)[:1], step, *arrays(most + 1)[1:])
    with pytest.raises(ValueError, match="CUDA"):  # past the index check
        kernel.fold(*arrays(most)[:1], step, *arrays(most)[1:])
    assert kernel.lib._lib is None and kernel.launches == 0
