"""The port's batched decommitment against the JAX package's:
decommit_async + finalize_many, and fri_decommit_async + finalize_with_extra,
give the same decommitments and FRI layer values byte for byte; a mesh of
D shards gives the one-device bytes; every finalize makes one device->host
pull (the recording's sync.decommit counter) and one read a gather (a shard's part of it on
a mesh), its positions uploaded once. Inputs are made with numpy from a
seed; every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.core import fri as jfri
from stwo_brainfuck_tpu.core import merkle as jmerkle
from stwo_brainfuck_tpu.core.channel import Blake2sChannel as JChannel
from stwo_brainfuck_tpu_torch import convert, tracing
from stwo_brainfuck_tpu_torch.core import fri as tfri
from stwo_brainfuck_tpu_torch.core import merkle as tmerkle
from stwo_brainfuck_tpu_torch.core.channel import Blake2sChannel as TChannel
from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig, TreeProver
from stwo_brainfuck_tpu_torch.parallel.merkle_sharded import commit_sharded
from stwo_brainfuck_tpu_torch.parallel.mesh import make_mesh
from stwo_brainfuck_tpu_torch.parallel.prove import ShardedOps

torch.set_num_threads(1)
P = 2**31 - 1

# tree shapes: level -> number of columns committed there
TREES = {"mixed": {9: 3, 7: 19, 4: 2, 0: 1}, "one level": {8: 5}}
# query sets at the deepest level (taken mod its size), or {level: positions}
QUERIES = {
    "scattered": [3, 500, 77, 256, 11],
    "duplicates": [40, 40, 41, 300, 40, 300],
    "adjacent pairs": [0, 1, 2, 3, 100, 101, 254, 255],
    "ends": [0, 511],
    "by level": {9: [5, 510], 7: [0, 127], 4: [15, 0]},
}


def _columns(tree: str) -> dict:
    rng = np.random.default_rng(len(tree))
    return {k: rng.integers(0, P, (c, 1 << k), dtype=np.uint32) for k, c in TREES[tree].items()}


def _queries(kind: str, max_log: int):
    q = QUERIES[kind]
    if isinstance(q, dict):
        return {k: [p % (1 << k) for p in v] for k, v in q.items() if k <= max_log}
    return [p % (1 << max_log) for p in q]


def _one_pull(fn):
    with tracing.record(0) as rec:
        out = fn()
    assert tracing.sync_counts([rec]) == {"sync.decommit": 1}, \
        "a finalize makes one device->host pull"
    return out


@pytest.mark.parametrize("include_values", [True, False])
@pytest.mark.parametrize("kind", list(QUERIES))
def test_decommit_async_matches_jax(kind, include_values):
    """Both trees' pendings finalized together in one pass, each against
    the JAX package's own decommit_async + finalize_many."""
    trees = {name: _columns(name) for name in TREES}
    jt = {n: jmerkle.commit({k: jnp.asarray(v) for k, v in c.items()}) for n, c in trees.items()}
    tt = {n: tmerkle.commit({k: convert.to_torch(v) for k, v in c.items()})
          for n, c in trees.items()}
    queries = {n: _queries(kind, max(trees[n])) for n in trees}
    got = _one_pull(lambda: tmerkle.finalize_many(
        [tmerkle.decommit_async(tt[n], queries[n], include_values) for n in trees]))
    for dec, n in zip(got, trees):
        want = jmerkle.finalize_many(
            [jmerkle.decommit_async(jt[n], queries[n], include_values=include_values)])[0]
        assert dec.to_json() == want.to_json(), n
        assert dec.to_json() == tmerkle.decommit(tt[n], queries[n], include_values).to_json()
        if include_values:
            sizes = {k: v.shape[0] for k, v in trees[n].items()}
            tmerkle.verify(tt[n].root, sizes, queries[n], dec)
        else:
            assert dec.column_values == {}


@pytest.mark.parametrize("d", [1, 4])
def test_one_read_a_part(monkeypatch, d):
    """Each gather is one read (core/merkle._take, one launch) on one
    device, one a shard holding some of its positions on a mesh, with the
    positions uploaded once."""
    cols = {k: convert.to_torch(v) for k, v in _columns("mixed").items()}
    mesh = make_mesh(d, "cpu")
    tree = tmerkle.commit(cols) if d == 1 else commit_sharded(mesh, cols)
    pending = tmerkle.decommit_async(tree, [3, 500, 77, 78])
    reads = tmerkle.Reads(pending.gathers())
    want = sum(1 if isinstance(g.source, torch.Tensor) else
               len(set(reads.positions[j] // g.source.chunk))
               for j, g in enumerate(reads.gathers))
    calls, uploads = [], []
    real_take, real_upload = tmerkle._take, tmerkle._upload
    monkeypatch.setattr(tmerkle, "_take", lambda *a: calls.append(1) or real_take(*a))
    monkeypatch.setattr(tmerkle, "_upload", lambda *a: uploads.append(1) or real_upload(*a))
    tmerkle.finalize_many([pending])
    assert len(calls) == want >= len(reads.gathers)
    assert len(uploads) == 1


def _fri_inputs(logs):
    rng = np.random.default_rng(sum(logs))
    return {lg: rng.integers(0, P, (4, 1 << lg), dtype=np.uint32) for lg in logs}


def _fri_prover(inputs, ops=None):
    ch = TChannel()
    ch.mix_u32s([1])
    wrap = convert.to_torch if ops is None else (lambda v: ops.mesh.shard(convert.to_torch(v)))
    prover = tfri.fri_commit({k: wrap(v) for k, v in inputs.items()}, ch, ops=ops)
    return prover, ch.draw_queries(8, max(inputs))


@pytest.mark.parametrize("logs", [[8], [9, 8, 4]])
def test_fri_decommit_async_matches_jax(logs):
    inputs = _fri_inputs(logs)
    ch = JChannel()
    ch.mix_u32s([1])
    jp = jfri.fri_commit({k: jnp.asarray(v) for k, v in inputs.items()}, ch)
    jqs = ch.draw_queries(8, max(logs))
    tp, tqs = _fri_prover(inputs)
    assert tqs == jqs
    jpos, jpend, jfuts = jfri.fri_decommit_async(jp, jqs)
    jdecs, jvals = jmerkle.finalize_with_extra(jpend, jfuts)
    tpos, tpend, tvals_req = tfri.fri_decommit_async(tp, tqs)
    tdecs, tvals = _one_pull(lambda: tmerkle.finalize_with_extra(tpend, tvals_req))
    assert tpos == jpos
    assert [d.to_json() for d in tdecs] == [d.to_json() for d in jdecs]
    for pos, got, want in zip(tpos, tvals, jvals):
        np.testing.assert_array_equal(got.astype(np.uint32), np.asarray(want)[:, :len(pos)])
    tfri.fri_decommit_finish(tp, tpos, tdecs, tvals)
    jfri.fri_decommit_finish(jp, jpos, jdecs, jvals)
    assert tp.proof.to_json() == jp.proof.to_json()


@pytest.mark.parametrize("d", [2, 4, 8])
def test_mesh_decommitment_matches_one_device(d):
    """A sharded tree, a sharded FRI and a plain committed tree (the
    levels under the split and the top are plain tensors) finalized in one
    pass on a mesh of d shards: the one-device bytes, one pull."""
    cols = _columns("mixed")
    inputs = _fri_inputs([9, 8, 4])
    mesh = make_mesh(d, "cpu")
    config = PcsConfig(log_blowup=1)
    ladder = [(4, convert.to_torch(cols[4][0]))]

    def decommitment(ops):
        tree = (tmerkle.commit if ops is None else lambda c: commit_sharded(mesh, c))(
            {k: convert.to_torch(v) for k, v in cols.items()})
        small = TreeProver(ladder, config, TChannel(), ops=ops)
        prover, queries = _fri_prover(inputs, ops)
        pos, pend, vals = tfri.fri_decommit_async(prover, queries)
        pendings = [tmerkle.decommit_async(tree, queries), tmerkle.decommit_async(small.tree, [7])]
        decs, host = _one_pull(lambda: tmerkle.finalize_with_extra(pendings + pend, vals))
        tfri.fri_decommit_finish(prover, pos, decs[2:], host)
        assert small.decommit({5: [7]}).to_json() == decs[1].to_json()
        return [x.to_json() for x in decs[:2]], prover.proof.to_json()

    assert decommitment(ShardedOps(mesh)) == decommitment(None)
