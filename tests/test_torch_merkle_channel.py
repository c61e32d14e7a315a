"""The port's Blake2s, channel and Merkle tree vs hashlib and the JAX
package: digests, transcript draws, PoW nonces, roots and decommitments
for mixed-size column sets. Bit- and byte-identical."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.core import blake2s as jblake
from stwo_brainfuck_tpu.core import merkle as jmerkle
from stwo_brainfuck_tpu.core.channel import Blake2sChannel as JChannel
from stwo_brainfuck_tpu.core.channel import _device_grind as jgrind
from stwo_brainfuck_tpu_torch import convert
from stwo_brainfuck_tpu_torch.core import blake2s as tblake
from stwo_brainfuck_tpu_torch.core import merkle as tmerkle
from stwo_brainfuck_tpu_torch.core.channel import Blake2sChannel as TChannel
from stwo_brainfuck_tpu_torch.core.channel import _device_grind as tgrind

torch.set_num_threads(1)
P = 2**31 - 1


@pytest.mark.parametrize("nwords", [1, 8, 10, 16, 17, 33])
def test_blake2s_matches_hashlib_and_jax(nwords):
    msgs = np.random.default_rng(nwords).integers(0, 2**32, (5, nwords), dtype=np.uint64)
    msgs = msgs.astype(np.uint32)
    words = torch.as_tensor(msgs.T.astype(np.int64))           # word-leading
    got = tblake.hash_words(words)
    want = np.asarray(jblake.hash_words(jnp.asarray(msgs)))
    np.testing.assert_array_equal(got.numpy().T.astype(np.uint32), want)
    for i in range(5):
        assert tblake.digest_to_bytes(got[:, i]) == hashlib.blake2s(
            msgs[i].astype("<u4").tobytes()).digest()


def test_blake2s_parts_and_short_length():
    """A message split over several parts (as Merkle nodes are: child
    digests then columns) and a true length shorter than its words (the
    40-byte PoW message)."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**31, (7, 4)).astype(np.int32)
    b = rng.integers(0, 2**31, (13, 4)).astype(np.int32)
    whole = tblake.hash_words(torch.as_tensor(np.concatenate([a, b])))
    parts = tblake.hash_parts([torch.as_tensor(a), torch.as_tensor(b)])
    assert torch.equal(whole, parts)
    msg = rng.integers(0, 2**32, (10, 3), dtype=np.uint64).astype(np.uint32)
    got = tblake.hash_words(torch.as_tensor(msg.astype(np.int64)), n_bytes=40)
    for i in range(3):
        assert tblake.digest_to_bytes(got[:, i]) == hashlib.blake2s(
            msg[:, i].astype("<u4").tobytes()).digest()


def test_channel_transcript_matches_jax():
    cj, ct = JChannel(), TChannel()
    for ch in (cj, ct):
        ch.mix_u32s([1, 2, 3])
        ch.mix_root(bytes(range(32)))
        ch.mix_felts([(5, 6, 7, 8)])
        ch.mix_u64(2**40 + 3)
    assert cj.draw_felts(3) == ct.draw_felts(3)
    assert cj.draw_queries(20, 12) == ct.draw_queries(20, 12)
    assert cj.digest == ct.digest


@pytest.mark.parametrize("bits", [8, 10])
def test_pow_nonce_matches_jax(bits):
    cj, ct = JChannel(), TChannel()
    cj.mix_u32s([99])
    ct.mix_u32s([99])
    assert ct.grind_pow(bits) == cj.grind_pow(bits)


def test_batched_pow_grind_matches_jax():
    """The torch batched grind (taken above 13 bits) finds the same
    smallest nonce as the JAX device grind."""
    ch = TChannel()
    ch.mix_u32s([7])
    want = jgrind(ch.digest, 14)
    assert tgrind(ch.digest, 14, "cpu") == want
    assert ch.check_pow_nonce(14, want)


def _mixed_columns(seed):
    rng = np.random.default_rng(seed)
    return {
        7: rng.integers(0, P, (3, 1 << 7), dtype=np.uint32),
        5: rng.integers(0, P, (19, 1 << 5), dtype=np.uint32),   # two blocks + children
        2: rng.integers(0, P, (1, 1 << 2), dtype=np.uint32),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_merkle_root_and_layers_match_jax(seed):
    cols = _mixed_columns(seed)
    jt = jmerkle.commit({k: jnp.asarray(v) for k, v in cols.items()})
    tt = tmerkle.commit({k: convert.to_torch(v) for k, v in cols.items()})
    assert tt.root == jt.root
    for k in range(8):
        np.testing.assert_array_equal(convert.digests_to_numpy(tt.layers[k]),
                                      np.asarray(jt.layers[k]))


def test_merkle_decommitments_match_jax_and_verify():
    cols = _mixed_columns(2)
    jt = jmerkle.commit({k: jnp.asarray(v) for k, v in cols.items()})
    tt = tmerkle.commit({k: convert.to_torch(v) for k, v in cols.items()})
    sizes = {k: v.shape[0] for k, v in cols.items()}
    for queries in ([0, 5, 63, 17, 127], {7: [3, 90], 5: [1, 2, 3], 2: [0, 1, 2, 3]}):
        dj = jmerkle.decommit(jt, queries)
        dt = tmerkle.decommit(tt, queries)
        assert dt.to_json() == dj.to_json()
        tmerkle.verify(tt.root, sizes, queries, dt)
        jmerkle.verify(jt.root, sizes, queries, dt)
    bad = tmerkle.decommit(tt, [9])
    bad.column_values[7][0][0] = (bad.column_values[7][0][0] + 1) % P
    with pytest.raises(tmerkle.MerkleVerificationError):
        tmerkle.verify(tt.root, sizes, [9], bad)


def test_merkle_witness_only_decommitment():
    cols = {6: np.random.default_rng(4).integers(0, P, (4, 64), dtype=np.uint32)}
    tt = tmerkle.commit({6: convert.to_torch(cols[6])})
    dec = tmerkle.decommit(tt, [8, 9, 10, 11], include_values=False)
    assert dec.column_values == {}
    assert len(dec.witness_hashes) > 0
