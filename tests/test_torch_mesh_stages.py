"""The mesh path's elementwise M31 stages (ops/mesh_kernels.py) on the CPU:
each stage's plain path against the int64 form the sharded FFT and the
composition's sum used before (kept here as the oracle) and, through the
whole sharded transform, against the unsharded fft.evaluate_plain /
interpolate_plain; the exchange in chunks of whole columns against the
whole-shard one; and a 4-shard mesh prove at log_blowup 4, byte-identical to the
one-device prove. Inputs are seeded int32 values with 0 and p - 1 among
them; every comparison is exact (integers mod p)."""

import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu_torch import air
from stwo_brainfuck_tpu_torch.core import fft, m31
from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig
from stwo_brainfuck_tpu_torch.entry import _small_machine
from stwo_brainfuck_tpu_torch.ops import mesh_kernels
from stwo_brainfuck_tpu_torch.parallel import fft_sharded
from stwo_brainfuck_tpu_torch.parallel.mesh import Sharded, make_mesh
from stwo_brainfuck_tpu_torch.parallel.prove import ShardedOps

P = 2**31 - 1


def _values(seed: int, shape) -> torch.Tensor:
    """Seeded canonical int32 values, with 0 and p - 1 at the front."""
    v = np.random.default_rng(seed).integers(0, P, shape, dtype=np.int64)
    flat = v.reshape(-1)
    flat[:4] = [0, P - 1, 0, P - 1][:flat.size]
    flat[-2:] = [P - 1, 0]
    return torch.as_tensor(v.astype(np.int32))


# the int64 forms of the stages that parallel/fft_sharded.py and
# ShardedOps._add computed before the in-place stages: the oracle
def _evaluate_int64(x, y, t, upper):
    return (m31.sub(y, m31.mul(x, t)) if upper else m31.add(x, m31.mul(y, t))).to(torch.int32)


def _interpolate_int64(x, y, t_inv, upper, scale):
    r = m31.mul(m31.sub(y, x), t_inv) if upper else m31.add(x, y)
    return m31.mul(r, scale).to(torch.int32)


def _add_int64(x, y):
    return ((x.to(torch.int64) + y) % P).to(torch.int32)


@pytest.mark.parametrize("n", [3, 9, 15])
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("stage", ["evaluate", "interpolate", "add"])
def test_stage_matches_the_int64_form_and_the_unsharded_transform(stage, d, n):
    mesh = make_mesh(d, "cpu")
    split = mesh.split_log
    c = 1 << (n - split)
    x, y = _values(17 * n + d, (2, c)), _values(31 * n + d, (2, c))
    # one stage of every shard at each of its cross distances, in place
    if stage == "add":
        want = _add_int64(x, y)
        got = x.clone()
        assert mesh_kernels.add_into(got, y) is got
        assert torch.equal(got, want)
    else:
        for k in range(split):
            for i in range(d):
                upper = bool(i & (1 << k))
                t = fft_sharded._cross_twiddles(n, d, stage == "interpolate")[split - 1 - k][i]
                got = x.clone()
                if stage == "evaluate":
                    want = _evaluate_int64(x, y, t, upper)
                    mesh_kernels.evaluate_cross(got, y, t, upper)
                else:
                    scale = fft.inv_pow2(n) if k == split - 1 else 1
                    want = _interpolate_int64(x, y, t, upper, scale)
                    mesh_kernels.interpolate_cross(got, y, t, upper, scale=scale)
                assert torch.equal(got, want), (stage, i, k)
                out = torch.empty_like(x)
                if stage == "evaluate":
                    mesh_kernels.evaluate_cross(x, y, t, upper, out=out)
                    assert torch.equal(out, want)

    # the whole transform (or the composition's sum) against the unsharded one
    whole = _values(n + 100 * d, (3, 1 << n))
    if stage == "evaluate":
        ev = fft_sharded.make_sharded_evaluate(mesh, n)
        assert torch.equal(ev(whole).full(), fft.evaluate_plain(whole, n))
        sh = mesh.shard(whole)
        assert torch.equal(ev(sh, consume=True).full(), fft.evaluate_plain(whole, n))
        assert torch.equal(ev(whole[1]).full(), fft.evaluate_plain(whole[1], n))
    elif stage == "interpolate":
        it = fft_sharded.make_sharded_interpolate(mesh, n)
        before = whole.clone()
        assert torch.equal(it(whole).full(), fft.interpolate_plain(whole, n))
        assert torch.equal(whole, before), "the interpolate leaves its input as it was"
    else:
        other = _values(n + 7, (4, 1 << n))
        a, b = mesh.shard(whole[:1].expand(4, -1).contiguous()), mesh.shard(other)
        summed = ShardedOps(mesh)._add(a, b)
        assert isinstance(summed, Sharded)
        assert torch.equal(summed.full(), _add_int64(whole[:1].expand(4, -1), other))


def test_the_evaluate_keeps_an_input_it_is_not_given():
    mesh = make_mesh(4, "cpu")
    x = mesh.shard(_values(3, (2, 1 << 10)))
    before = x.full().clone()
    out = fft_sharded.make_sharded_evaluate(mesh, 10)(x)
    assert torch.equal(x.full(), before)
    assert torch.equal(out.full(), fft.evaluate_plain(before, 10))


def test_one_shard_scales_in_its_local_stages():
    mesh = make_mesh(1, "cpu")
    x = _values(5, (2, 1 << 9))
    assert torch.equal(fft_sharded.make_sharded_interpolate(mesh, 9)(x).full(),
                       fft.interpolate_plain(x, 9))


@pytest.mark.parametrize("per", [1, 2, 3])
@pytest.mark.parametrize("dist", [1, 2])
def test_the_chunked_exchange_receives_the_whole_shard_s_columns(dist, per, monkeypatch):
    """A stage's exchange in chunks of `per` whole columns (EXCHANGE_BYTES
    set to that many columns; 3 rows: chunks of 1, of 2 and 1, of 3)
    delivers the partner's shard, chunk by chunk, as the whole-shard
    exchange does, and leaves the shards as they were."""
    mesh = make_mesh(4, "cpu")
    v = mesh.shard(_values(11, (3, 1 << 8))).shards
    whole = mesh.exchange(v, dist, out=[torch.empty_like(s) for s in v])
    monkeypatch.setattr(fft_sharded, "EXCHANGE_BYTES", per * 4 * (1 << 6))
    seen = [[] for _ in range(4)]

    def keep(i, own, partner, out):
        assert own.numel() == partner.numel() == out.numel() <= per * (1 << 6)
        seen[i].append(partner.clone())

    before = [s.clone() for s in v]
    fft_sharded.cross_stage(mesh, v, dist, keep)
    for i in range(4):
        assert len(seen[i]) == -(-3 // per)
        assert torch.equal(torch.cat(seen[i]).reshape(whole[i].shape), whole[i])
        assert torch.equal(v[i], before[i])
    # into given buffers: every shard's column read before any is written
    bufs = [torch.full((1 << 6,), -1, dtype=torch.int32) for _ in range(4)]
    got = mesh.exchange([s[0] for s in v], dist, out=bufs)
    assert all(g is b for g, b in zip(got, bufs))
    for i in range(4):
        assert torch.equal(bufs[i], v[i ^ dist][0])


def test_the_stages_refuse_what_the_kernel_cannot_take():
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        mesh_kernels.add_into(x, torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        mesh_kernels.add_into(x, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        mesh_kernels.add_into(torch.zeros((4, 4), dtype=torch.int32).t(),
                              torch.zeros((4, 4), dtype=torch.int32))


def test_a_four_shard_prove_at_blowup_4_is_the_one_device_proof():
    config = PcsConfig(log_blowup=4, log_max_rows=0)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = air.prove_brainfuck(_small_machine(), config, device="cpu")
        four = air.prove_brainfuck(_small_machine(), config, device="cpu",
                                   mesh=make_mesh(4, "cpu"))
    finally:
        torch.set_num_threads(threads)
    assert four == one
    air.verify_brainfuck(four, device="cpu")


def test_chip_smoke_s_mesh_checks_hold_on_a_four_shard_prove(monkeypatch):
    """chip_smoke's mesh checks on a CPU prove: the decommit phase's
    collectives read from the recording (one pull, one gather_many), and
    one stage call a shard in each `fft.cross` span plus one a sum, the
    count a card's mesh-stage launches are held to (a CPU shard's stage
    is one plain call where a card's is one launch)."""
    import chip_smoke
    from stwo_brainfuck_tpu_torch import tracing

    calls = [0]
    plain = mesh_kernels.stage_plain

    def counted(*args):
        calls[0] += 1
        return plain(*args)

    monkeypatch.setattr(mesh_kernels, "stage_plain", counted)
    with tracing.record(0) as rec, chip_smoke._counting_sums() as sums:
        timer = chip_smoke._PhaseCalls("cpu")
        proof = air.prove_brainfuck(_small_machine(), device="cpu", timer=timer,
                                    mesh=make_mesh(4, "cpu"))
    air.verify_brainfuck(proof, device="cpu")
    cross = sum(1 for sp in rec.spans if sp.name == "fft.cross")
    assert cross > 0 and calls[0] == 4 * cross + sums.call_count
    chip_smoke._mesh_stages_per_prove(calls[0], rec, sums.call_count, 4, "cpu prove")
    with pytest.raises(AssertionError, match="mesh-stage launches"):
        chip_smoke._mesh_stages_per_prove(calls[0] - 1, rec, sums.call_count, 4, "cpu prove")
    with pytest.raises(AssertionError, match="mesh-stage launches"):
        chip_smoke._mesh_stages_per_prove(calls[0], rec, sums.call_count, 0, "cpu prove")
    assert chip_smoke._decommit_phase(timer.seconds["decommit"], timer.calls["decommit"],
                                      "cpu prove", mesh=True)["mesh.gather_many"] == 1
    assert sum(v.get("mesh.exchange", 0) for v in timer.calls.values()) == cross
