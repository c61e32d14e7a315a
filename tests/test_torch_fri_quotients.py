"""The port's quotient accumulation and FRI vs the JAX package's: the
prover's combined quotients, FRI layer roots, last value, transcript and
decommitments on mixed-size inputs, and the verifier's checks (each
package's verifier on the other's FRI proof, tampering rejected)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.core import fft as jfft
from stwo_brainfuck_tpu.core import fri as jfri
from stwo_brainfuck_tpu.core import quotients as jq
from stwo_brainfuck_tpu.core.channel import Blake2sChannel as JChannel
from stwo_brainfuck_tpu_torch import convert
from stwo_brainfuck_tpu_torch.core import fri as tfri
from stwo_brainfuck_tpu_torch.core import quotients as tq
from stwo_brainfuck_tpu_torch.core.channel import Blake2sChannel as TChannel
from stwo_brainfuck_tpu_torch.core.circle import point_from_t
from stwo_brainfuck_tpu_torch.core.pcs import shifted_point

torch.set_num_threads(1)
P = 2**31 - 1


def _felt(rng):
    return tuple(int(v) for v in rng.integers(0, P, 4))


def _claims(rng, n_cols, trace_log):
    """Column claims at z (every column) and z - g (every third column)."""
    z = point_from_t(_felt(rng))
    claims, aidx = [], 0
    for c in range(n_cols):
        cl = []
        for shift in ((0, 1) if c % 3 == 0 else (0,)):
            cl.append((shifted_point(z, trace_log, shift), _felt(rng), aidx))
            aidx += 1
        claims.append(cl)
    return claims


@pytest.mark.parametrize("log_size,n_cols", [(5, 4), (7, 9)])
def test_accumulate_quotients_matches_jax(log_size, n_cols):
    rng = np.random.default_rng(log_size)
    cols = rng.integers(0, P, (n_cols, 1 << log_size), dtype=np.uint32)
    raw = _claims(rng, n_cols, log_size - 1)
    alpha = _felt(rng)
    want = jq.accumulate_quotients(
        log_size, [jnp.asarray(c) for c in cols],
        [[jq.QuotientClaim(p, v, a) for p, v, a in cl] for cl in raw], alpha)
    got = tq.accumulate_quotients(
        {log_size: ([convert.to_torch(c) for c in cols],
                    [[tq.QuotientClaim(p, v, a) for p, v, a in cl] for cl in raw])},
        alpha)[log_size]
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))
    # the verifier's batched reconstruction at a few positions agrees
    positions = [0, 3, (1 << log_size) - 1]
    claims_t = [[tq.QuotientClaim(p, v, a) for p, v, a in cl] for cl in raw]
    prepared = tq.prepare_point_groups(claims_t, alpha)
    vals = tq.quotient_values_batch(log_size, positions,
                                    cols[:, positions].astype(np.uint64), prepared)
    for i, pos in enumerate(positions):
        assert vals[pos] == tuple(int(x) for x in np.asarray(want)[:, pos])
    assert vals == jq.quotient_values_batch(
        log_size, positions, cols[:, positions].astype(np.uint64),
        jq.prepare_point_groups(
            [[jq.QuotientClaim(p, v, a) for p, v, a in cl] for cl in raw], alpha))


def test_domain_points_match_jax():
    for log in (1, 3, 8):
        xs, ys = jq.domain_points_storage(log)
        gx, gy = tq.domain_points_storage(log, "cpu")
        np.testing.assert_array_equal(gx.numpy(), xs.astype(np.int64))
        np.testing.assert_array_equal(gy.numpy(), ys.astype(np.int64))


def _low_degree(rng, log_size):
    n = 1 << log_size
    coeffs = np.zeros((4, n), np.uint32)
    coeffs[:, : n // 2] = rng.integers(0, P, (4, n // 2), dtype=np.uint32)
    return np.stack([np.asarray(jfft.evaluate(jnp.asarray(coeffs[k]), log_size))
                     for k in range(4)])


def _run_fri(mod, chan_cls, inputs, to_array):
    ch = chan_cls()
    ch.mix_u32s([1])
    prover = mod.fri_commit({k: to_array(v) for k, v in inputs.items()}, ch)
    queries = ch.draw_queries(8, max(inputs))
    mod.fri_decommit(prover, queries)
    return prover, queries, ch


def _betas(proof):
    ch = TChannel()
    ch.mix_u32s([1])
    beta0 = ch.draw_felt()
    betas = []
    for root in proof.layer_roots:
        ch.mix_root(root)
        betas.append(ch.draw_felt())
    return beta0, betas


@pytest.mark.parametrize("logs", [[7], [8, 6, 5], [9, 8, 4]])
def test_fri_commit_and_decommit_match_jax(logs):
    rng = np.random.default_rng(sum(logs))
    inputs = {lg: _low_degree(rng, lg) for lg in logs}
    jp, jqs, jch = _run_fri(jfri, JChannel, inputs, jnp.asarray)
    tp, tqs, tch = _run_fri(tfri, TChannel, inputs, convert.to_torch)
    assert tqs == jqs
    assert tch.digest == jch.digest
    assert tp.proof.to_json() == jp.proof.to_json()
    for tl, jl in zip(tp.layer_evals, jp.layer_evals):
        np.testing.assert_array_equal(convert.to_numpy(tl), np.asarray(jl))

    def input_fn(log, pos):
        return None if log not in inputs else tuple(int(x) for x in inputs[log][:, pos])

    beta0, betas = _betas(tp.proof)
    tfri.fri_verify_queries(tp.proof, (beta0, betas), max(logs), tqs, input_fn)
    jfri.fri_verify_queries(tp.proof, (beta0, betas), max(logs), tqs, input_fn)
    bad = copy.deepcopy(tp.proof)
    k = next(iter(bad.layer_values[0]))
    bad.layer_values[0][k] = tuple((v + 1) % P for v in bad.layer_values[0][k])
    with pytest.raises(tfri.FriVerificationError):
        tfri.fri_verify_queries(bad, (beta0, betas), max(logs), tqs, input_fn)


def test_fri_rejects_high_degree_input():
    rng = np.random.default_rng(11)
    inputs = {7: rng.integers(0, P, (4, 1 << 7), dtype=np.uint32)}
    tp, tqs, _ = _run_fri(tfri, TChannel, inputs, convert.to_torch)
    beta0, betas = _betas(tp.proof)
    with pytest.raises(tfri.FriVerificationError):
        tfri.fri_verify_queries(
            tp.proof, (beta0, betas), 7, tqs,
            lambda log, pos: tuple(int(x) for x in inputs[log][:, pos]) if log in inputs else None)


@pytest.mark.parametrize("chunk", [1, 3, 64, 1 << 10])
def test_fold_in_chunks_matches_jax(monkeypatch, chunk):
    """A fold of more than _FOLD_CHUNK output positions runs chunk by chunk
    into one output: the same values as the JAX package's fold, for chunks
    that divide the output or leave a ragged last one."""
    rng = np.random.default_rng(chunk)
    vals = rng.integers(0, P, (4, 1 << 11), dtype=np.uint32)
    itw = tfri._fold_itw("c", 11, "cpu")
    beta = _felt(rng)
    want = np.asarray(jfri._fold(jnp.asarray(vals), jnp.asarray(itw.numpy().astype(np.uint32)),
                                 beta))
    monkeypatch.setattr(tfri, "_FOLD_CHUNK", chunk)
    got = tfri._fold(convert.to_torch(vals), itw, beta)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
