"""The batched decommitment on the card (marker `gpu`; skipped without
one): trees and FRI layers committed on the card decommit to the CPU's
bytes, with one device->host pull a finalize, on one device, on a mesh of
shards sharing the card and on one over the card and the CPU. Imports no
jax:

    python -m pytest --noconftest -m gpu tests/test_torch_decommit_gpu.py
"""

import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu_torch import tracing
from stwo_brainfuck_tpu_torch.core import fri, merkle
from stwo_brainfuck_tpu_torch.core.channel import Blake2sChannel
from stwo_brainfuck_tpu_torch.parallel.merkle_sharded import commit_sharded
from stwo_brainfuck_tpu_torch.parallel.mesh import DeviceMesh, make_mesh
from stwo_brainfuck_tpu_torch.parallel.prove import ShardedOps

pytestmark = pytest.mark.gpu
P = 2**31 - 1
# level -> columns, and the query sets (deepest-level positions, or by level)
TREE = {16: 4, 14: 40, 9: 3, 4: 1}
QUERIES = ([5, 5, 6, 7, (1 << 16) - 1, 0, 12345, 54321],
           {16: [1, 2, 3], 12: [9, 4000], 2: [0, 3]})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Blake2s tree kernel has no CPU mode")
    return torch.device("cuda")


def _columns() -> dict:
    rng = np.random.default_rng(20)
    return {k: torch.as_tensor(rng.integers(0, P, (c, 1 << k)).astype(np.int32))
            for k, c in TREE.items()}


def _served(fn):
    with tracing.record(0) as rec:
        out = fn()
    assert rec.counters.get("sync.decommit") == 1, "one device->host pull a finalize"
    return out


@pytest.mark.parametrize("include_values", [True, False])
def test_decommit_on_the_card_matches_cpu(cuda, include_values):
    cols = _columns()
    extra = [(cols[14], [0, 17, (1 << 14) - 1])]

    def run(dev):
        tree = merkle.commit({k: v.to(dev) for k, v in cols.items()})
        return _served(lambda: merkle.finalize_with_extra(
            [merkle.decommit_async(tree, q, include_values) for q in QUERIES],
            [merkle.Gather(m.to(dev), pos) for m, pos in extra]))

    (card_decs, card_extra), (cpu_decs, cpu_extra) = run(cuda), run(torch.device("cpu"))
    assert [d.to_json() for d in card_decs] == [d.to_json() for d in cpu_decs]
    for a, b in zip(card_extra, cpu_extra):
        np.testing.assert_array_equal(a, b)


def _fri(dev, ops=None):
    rng = np.random.default_rng(21)
    inputs = {lg: torch.as_tensor(rng.integers(0, P, (4, 1 << lg)).astype(np.int32), device=dev)
              for lg in (16, 15, 10)}
    if ops is not None:
        inputs = {k: ops.mesh.shard(v) for k, v in inputs.items()}
    ch = Blake2sChannel()
    prover = fri.fri_commit(inputs, ch, ops=ops)
    return prover, ch.draw_queries(20, 16)


@pytest.mark.parametrize("d", [1, 4])
def test_fri_and_mesh_decommit_on_the_card_match_cpu(cuda, d):
    """A tree and an FRI committed on the card (on a mesh of d shards
    sharing it, for d > 1) against the same on the CPU."""
    cols = _columns()

    def run(dev, mesh):
        ops = ShardedOps(mesh) if mesh is not None else None
        placed = {k: v.to(dev) for k, v in cols.items()}
        tree = merkle.commit(placed) if mesh is None else commit_sharded(mesh, placed)
        prover, queries = _fri(dev, ops)
        pos, pend, vals = fri.fri_decommit_async(prover, queries)
        decs, host = _served(lambda: merkle.finalize_with_extra(
            [merkle.decommit_async(tree, queries)] + pend, vals))
        fri.fri_decommit_finish(prover, pos, decs[1:], host)
        return decs[0].to_json(), prover.proof.to_json()

    mesh = make_mesh(d, "cuda") if d > 1 else None
    assert run(cuda, mesh) == run(torch.device("cpu"), None)


def test_mesh_over_two_devices_matches_one_device(cuda):
    """A tree sharded over the card and the CPU (shards 0 and 2 on the
    card, 1 and 3 on the CPU): the CPU shards' reads are gathered there and
    moved to the card with one copy, and the decommitment is the
    one-device bytes, with one pull."""
    cols = _columns()
    mesh = DeviceMesh((cuda, torch.device("cpu"), cuda, torch.device("cpu")))
    tree = commit_sharded(mesh, cols)
    want = merkle.commit(cols)
    assert tree.root == want.root
    for q in QUERIES:
        got = _served(lambda: merkle.finalize_many([merkle.decommit_async(tree, q)]))[0]
        assert got.to_json() == merkle.decommit(want, q).to_json()
