"""One process of tests/test_torch_multihost.py's process groups (imports
the port only, never jax):

    STWO_BF_NUM_PROCESSES=W STWO_BF_COORDINATOR=127.0.0.1:PORT STWO_BF_PROCESS_ID=R \\
        python tests/torch_multihost_worker.py OUT_DIR

joins a gloo group of W processes on the CPU, runs every collective of the
ProcessGroupMesh on the seeded inputs of ``inputs(W)`` (and, at W = 2, the
sharded evaluate, interpolate and extend of ``fft_input()`` and the batched
decommitment of ``decommit_inputs()``), and saves what this process got to
OUT_DIR/rank{R}.pt; ``... OUT_DIR traced_prove`` instead proves the small
program inside a recording (``traced_prove``).
"""

import json
import os
import sys

import numpy as np
import torch

P = 2**31 - 1
FFT_LOG = 10


def inputs(world: int) -> dict:
    """The collectives' inputs, the same in every process and in the test."""
    rng = np.random.default_rng(world)
    return {"x": torch.as_tensor(rng.integers(0, P, (3, 64)).astype(np.int64)),
            "perm": torch.as_tensor(rng.permutation(64)),
            "positions": [63, 0, 17, 5, 32, 31, 48],
            "pad_log": 8}


def fft_input() -> torch.Tensor:
    rng = np.random.default_rng(99)
    return torch.as_tensor(rng.integers(0, P, (2, 1 << FFT_LOG)).astype(np.int32))


def collectives(mesh) -> dict:
    """Every collective on ``inputs(mesh.size)``: what this process holds
    of each output (its own shard's entry, or the replicated result)."""
    inp = inputs(mesh.size)
    me = mesh.local[0]
    sh = mesh.shard(inp["x"])
    out = {"all_gather": mesh.all_gather(mesh.each(lambda i: sh.shards[i][:, 0]))[me],
           "shift": mesh.shift(sh.shards)[me],
           "permute": mesh.permute(sh.shards, inp["perm"])[me],
           "full": sh.full(),
           "gather": sh.gather(inp["positions"]),
           "pad": mesh.pad(sh, inp["pad_log"]).shards[me],
           "sum": mesh.sum(mesh.each(lambda i: sh.shards[i]))}
    for k in range(mesh.split_log):
        recv = mesh.each(lambda i: torch.empty_like(sh.shards[i]))
        out[f"exchange{1 << k}"] = mesh.exchange(sh.shards, 1 << k, out=recv)[me]
    return out


def transforms(mesh) -> dict:
    from stwo_brainfuck_tpu_torch.parallel import fft_sharded

    x = fft_input()
    coeffs, ext = fft_sharded.sharded_extend(mesh, x, FFT_LOG, 1)
    return {"evaluate": fft_sharded.make_sharded_evaluate(mesh, FFT_LOG)(x).full(),
            "interpolate": fft_sharded.make_sharded_interpolate(mesh, FFT_LOG)(x).full(),
            "extend_coeffs": coeffs.full(), "extend": ext.full()}


def decommit_inputs() -> dict:
    """The decommitment case's columns (level -> (C, 2^k)), queries and
    extra positions, the same in every process and in the test."""
    rng = np.random.default_rng(13)
    return {"columns": {6: rng.integers(0, P, (3, 64)).astype(np.int32),
                        3: rng.integers(0, P, (2, 8)).astype(np.int32)},
            "queries": [0, 9, 63, 40, 41, 9], "positions": [63, 0, 17, 5, 32]}


def decommitment(mesh) -> dict:
    """A sharded tree's decommitment finalized in one pass with two extra
    gathers (of a sharded array and of a plain one, which only rank 0
    writes), and the all_reduce calls and device->host pulls it made."""
    from stwo_brainfuck_tpu_torch import tracing
    from stwo_brainfuck_tpu_torch.core import merkle
    from stwo_brainfuck_tpu_torch.parallel import mesh as mesh_mod
    from stwo_brainfuck_tpu_torch.parallel.merkle_sharded import commit_sharded

    inp = decommit_inputs()
    cols = {k: torch.as_tensor(v) for k, v in inp["columns"].items()}
    tree = commit_sharded(mesh, cols)
    sharded = mesh.shard(cols[6])
    all_reduce = mesh_mod.tdist.all_reduce
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return all_reduce(*args, **kwargs)

    mesh_mod.tdist.all_reduce = counted
    try:
        with tracing.record(0) as rec:
            decs, extra = merkle.finalize_with_extra(
                [merkle.decommit_async(tree, inp["queries"])],
                [merkle.Gather(sharded, inp["positions"]),
                 merkle.Gather(cols[6], inp["positions"])])
    finally:
        mesh_mod.tdist.all_reduce = all_reduce
    return {"decommit_json": json.dumps(decs[0].to_json()),
            "decommit_extra": torch.from_numpy(np.stack(extra)),
            "decommit_counts": torch.tensor([len(calls), rec.counters.get("sync.decommit", 0)])}


def traced_prove(mesh) -> dict:
    """The small program proved on the process mesh inside a recording,
    with every payload this process hands to torch.distributed summed
    beside it: the proof, the recording's spans (name, phase) and
    counters, and the payloads' bytes."""
    from stwo_brainfuck_tpu_torch import air, tracing
    from stwo_brainfuck_tpu_torch.entry import _small_machine
    from stwo_brainfuck_tpu_torch.parallel import mesh as mesh_mod

    tdist = mesh_mod.tdist
    payloads = []
    real = {k: getattr(tdist, k) for k in ("all_gather", "batch_isend_irecv",
                                           "all_to_all_single", "all_reduce")}
    wrapped = {
        "all_gather": lambda parts, x, *a, **k: (payloads.append(x.nbytes),
                                                 real["all_gather"](parts, x, *a, **k))[1],
        "batch_isend_irecv": lambda ops: (payloads.append(sum(
            op.tensor.nbytes for op in ops if op.op is tdist.isend)),
            real["batch_isend_irecv"](ops))[1],
        "all_to_all_single": lambda out, inp, *a, **k: (
            payloads.append(inp.nbytes), real["all_to_all_single"](out, inp, *a, **k))[1],
        "all_reduce": lambda x, *a, **k: (payloads.append(x.nbytes),
                                          real["all_reduce"](x, *a, **k))[1]}
    machine = _small_machine()
    for k, fn in wrapped.items():
        setattr(tdist, k, fn)
    try:
        with tracing.record(0) as rec:
            proof = air.prove_brainfuck(machine, device="cpu", mesh=mesh)
    finally:
        for k, fn in real.items():
            setattr(tdist, k, fn)
    spans = [(s.start_ns, s.end_ns, s.name) for s in rec.spans]
    phases = tracing.phase_of(spans)
    return {"traced_proof": json.dumps(proof),
            "traced_spans": [(name, ph) for (_, _, name), ph in zip(spans, phases)],
            "traced_counters": dict(rec.counters), "traced_payloads": sum(payloads)}


def main(out_dir: str, mode: str = "collectives") -> None:
    from stwo_brainfuck_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(device="cpu")
    try:
        mesh = multihost.global_mesh()
        if mode == "traced_prove":
            got = traced_prove(mesh)
        else:
            got = collectives(mesh)
            if mesh.size == 2:
                got.update(transforms(mesh))
                got.update(decommitment(mesh))
        torch.save(got, os.path.join(out_dir, f"rank{mesh.local[0]}.pt"))
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:3])
