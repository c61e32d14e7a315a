"""The four-card cell production.big22.w4 and its readers: the cell loads
through load_cell, reports exactly its metrics (and the older cells what
they reported), arith_mesh's count of the mesh stages' bytes equals the
bytes the stages move on a 4-shard CPU mesh, and the two new readers read
rank 0's kernels (nothing where the program has no such kernel)."""

import harness
from arith import PEAK_BYTES_PER_S
from arith_mesh import BYTES_A_POSITION, cross_bytes

CELL = "production.big22.w4"
NEW_PER_LAYER = {"host.prove_rate.w4", "mem.commit_gb.w4", "mem.fri_gb.w4",
                 "device.idle_share.w4", "mesh.nccl_ms", "cross_roofline"}
# what the three older cells reported before this cell came
OLDER = {
    "production.fib19_io": ({"prove_rate", "prove_p95_s", "peak_mem_gb", "setup_s"},
                            {"vm.trace_ms", "tables.ms", "commit.ms", "air.ms", "fri.ms",
                             "decommit.ms", "kernels.blake2s_ms", "quotients_roofline",
                             "device.idle_share", "mem.commit_gb", "mem.fri_gb"}),
    "default.big22": ({"peak_mem_gb", "setup_s"},
                      {"mem.commit_gb", "mem.fri_gb", "host.prove_rate",
                       "device.idle_share.default"}),
    "default.fib19_io": ({"peak_mem_gb", "setup_s"},
                         {"mem.commit_gb", "mem.fri_gb", "host.prove_rate",
                          "device.idle_share.default"}),
}


def test_the_cell_loads_with_big22_s_claim_at_production_on_four_cards():
    cell = harness.load_cell(CELL)
    big22 = harness.load_cell("default.big22")
    prod = harness.load_cell("production.fib19_io")
    assert cell.chips == 4 and cell.config == prod.config
    assert cell.spec["config"] == "production.w4"  # its own deployment, production's PcsConfig
    assert cell.claims == big22.claims
    assert [e.name for e in cell.traffic.entries] == ["big22"]
    assert (cell.spec["warm_proves"], cell.spec["checked_requests"],
            cell.spec["traced_requests"]) == (3, 3, 16)


def test_the_cells_report_exactly_their_metrics():
    bench = harness.load_benchmark()
    e2e, per = harness.cell_metrics(bench, CELL)
    assert {m["name"] for m in e2e} == {"peak_mem_gb", "setup_s"}
    assert {m["name"] for m in per} == NEW_PER_LAYER
    assert all(m["moves"] == "peak_mem_gb" for m in per)
    for name, (want_e2e, want_per) in OLDER.items():
        e2e, per = harness.cell_metrics(bench, name)
        assert {m["name"] for m in e2e} == want_e2e, name
        assert {m["name"] for m in per} == want_per, name
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert [w["name"] for w in four] == [CELL]
    for m in per:
        harness.metric_reader(m["name"])  # every reader is found


def test_arith_mesh_counts_the_bytes_the_stages_move_on_a_cpu_mesh(monkeypatch):
    import torch

    from stwo_brainfuck_tpu_torch import air
    from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig
    from stwo_brainfuck_tpu_torch.entry import _small_machine
    from stwo_brainfuck_tpu_torch.ops import mesh_kernels
    from stwo_brainfuck_tpu_torch.parallel.mesh import make_mesh

    moved = []
    plain = mesh_kernels.stage_plain

    def counted(op, x, y, c, out):
        moved.append(BYTES_A_POSITION * x.numel())
        return plain(op, x, y, c, out)

    monkeypatch.setattr(mesh_kernels, "stage_plain", counted)
    for config in ({"log_blowup": 1, "n_queries": 8, "pow_bits": 4, "log_max_rows": 0},
                   {"log_blowup": 4, "n_queries": 8, "pow_bits": 4, "log_max_rows": 0}):
        moved.clear()
        threads = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            proof = air.prove_brainfuck(_small_machine(), PcsConfig(**config), device="cpu",
                                        mesh=make_mesh(4, "cpu"))
        finally:
            torch.set_num_threads(threads)
        claim = {k: int(v) for k, v in proof["claim"].items()}
        assert moved and sum(moved) % 4 == 0
        assert cross_bytes(claim, config, 4) == sum(moved) // 4, config
        assert cross_bytes(claim, config, 1) == 0


def _run(kernel_s, traced=2):
    cell = harness.load_cell(CELL)
    run = harness.Run(cell, 1, True)
    run.traced = harness.TraceData(window_s=1.0, busy_s=0.5, requests=traced,
                                   kernel_s=dict(kernel_s))
    run.requests = [harness.Request("big22", 1324084, 0.5, 0.1, 0.0, 0.5, True)
                    for _ in range(traced)]
    return run


def test_the_readers_read_rank_0_s_kernels_and_nothing_without_them():
    cross = harness.metric_reader("cross_roofline")
    nccl = harness.metric_reader("mesh.nccl_ms")
    cell = harness.load_cell(CELL)
    least = cross_bytes(cell.claims["big22"], cell.config, 4) / PEAK_BYTES_PER_S
    run = _run({"void (anonymous namespace)::mesh_cross_kernel<2>(unsigned int const*)": least,
                "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)": 0.004,
                "ncclKernel_AllReduce_RING_LL_Sum_int32_t(ncclWorkElem)": 0.002,
                "nccl:coalesced": 0.005,  # the profiler's annotation over the kernel
                "fft_pass<4, 0>": 1.0})
    assert abs(cross(run) - 200.0) < 1e-9  # two requests' least time in one request's
    assert abs(nccl(run) - 3.0) < 1e-9
    bare = _run({"fft_pass<4, 0>": 1.0})
    assert cross(bare) is None and nccl(bare) is None
    assert cross(_run({}, traced=0)) is None
