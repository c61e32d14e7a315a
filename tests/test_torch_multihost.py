"""Multi-process proving over torch.distributed on the CPU (gloo): the
process-group mesh's collectives against the one-process mesh's, the
sharded circle FFT at two processes against the JAX package's one-device
transforms, and the CLI's `prove --distributed` at two and four processes
(and under torchrun), whose proof is byte-identical to the JAX package's
one-device proof and verified by both packages. Each process group is started with subprocess,
on a free localhost port, with its own timeout; inputs are made with numpy
from a seed, and every comparison is exact (integers mod p)."""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_multihost_worker as worker
from stwo_brainfuck_tpu import air as jair
from stwo_brainfuck_tpu.core import fft as jfft
from stwo_brainfuck_tpu_torch import air as tair
from stwo_brainfuck_tpu_torch.parallel import multihost
from stwo_brainfuck_tpu_torch.parallel.mesh import DeviceMesh, make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
DIST_ENV = ("STWO_BF_NUM_PROCESSES", "STWO_BF_COORDINATOR", "STWO_BF_PROCESS_ID",
            "STWO_BF_BACKEND", "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
            "MASTER_PORT")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(world: int, argv_of_rank) -> list:
    """Start `world` processes (rank r runs argv_of_rank(r)) in one gloo
    group on a free localhost port; wait for all; return [(rc, stdout,
    stderr)] by rank. Every process is ended, whatever happens."""
    port = _free_port()
    procs = []
    try:
        for rank in range(world):
            env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
            env.update({"STWO_BF_NUM_PROCESSES": str(world),
                        "STWO_BF_COORDINATOR": f"127.0.0.1:{port}",
                        "STWO_BF_PROCESS_ID": str(rank), "PYTHONPATH": ROOT,
                        "OMP_NUM_THREADS": "1"})
            procs.append(subprocess.Popen(argv_of_rank(rank), cwd=ROOT, env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]
    for rank, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {rank} of {world} exited {rc}:\n{err.decode()[-3000:]}"
    return res


# ---------------------------------------------------------------------------
# One process: initialize is a no-op
# ---------------------------------------------------------------------------

def test_initialize_is_a_noop_in_one_process(monkeypatch):
    for k in DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    multihost.initialize(device="cpu")
    try:
        assert not torch.distributed.is_initialized()
        mesh = multihost.global_mesh()
        assert isinstance(mesh, DeviceMesh) and mesh.size == 1
        assert mesh.home == torch.device("cpu") and list(mesh.local) == [0]
        assert multihost.is_coordinator()
    finally:
        multihost.shutdown()
    with pytest.raises(RuntimeError, match="initialize"):
        multihost.global_mesh()


def test_one_card_has_one_device_key(monkeypatch):
    """"cuda", "cuda:0" and torch.device("cuda", 0) name one card, so the
    ladder tree and the verifier's root are cached once for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    keys = {str(tair.canonical_device(d)) for d in ("cuda", "cuda:0", torch.device("cuda", 0))}
    assert keys == {"cuda:0"}
    assert str(tair.canonical_device("cpu")) == "cpu"
    # every process of a group on the one card names it the same way
    assert {multihost.rank_device("cuda", r) for r in range(4)} == {torch.device("cuda", 0)}


# ---------------------------------------------------------------------------
# The process-group mesh's collectives against the one-process mesh's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Each world's per-rank results (worker.collectives, and at world 2
    worker.transforms)."""
    out = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"world{world}")
        _run_group(world, lambda r: [sys.executable, os.path.join(ROOT, "tests",
                                                                  "torch_multihost_worker.py"),
                                     str(d)])
        out[world] = [torch.load(d / f"rank{r}.pt") for r in range(world)]
    return out


def _in_process(world: int) -> list:
    """worker.collectives on the one-process mesh, as each rank would hold it."""
    mesh = make_mesh(world, "cpu")
    inp = worker.inputs(world)
    sh = mesh.shard(inp["x"])
    whole = {"full": sh.full(), "gather": sh.gather(inp["positions"]),
             "sum": mesh.sum(sh.shards)}
    per = {"all_gather": mesh.all_gather([s[:, 0] for s in sh.shards]),
           "shift": mesh.shift(sh.shards), "permute": mesh.permute(sh.shards, inp["perm"]),
           "pad": mesh.pad(sh, inp["pad_log"]).shards}
    for k in range(mesh.split_log):
        per[f"exchange{1 << k}"] = mesh.exchange(sh.shards, 1 << k,
                                                 out=[torch.empty_like(s) for s in sh.shards])
    return [{**whole, **{k: v[r] for k, v in per.items()}} for r in range(world)]


@pytest.mark.parametrize("op", ["all_gather", "exchange", "shift", "permute", "full", "gather",
                                "pad", "sum"])
@pytest.mark.parametrize("world", [2, 4])
def test_process_group_collectives_match_the_one_process_mesh(groups, world, op):
    want = _in_process(world)
    x = worker.inputs(world)["x"].numpy()
    for rank in range(world):
        got = groups[world][rank]
        keys = [k for k in got if k.startswith(op) and k[len(op):].isdigit() or k == op]
        assert keys, op
        for k in keys:
            np.testing.assert_array_equal(got[k].numpy(), want[rank][k].numpy(),
                                          err_msg=f"{k} on rank {rank} of {world}")
    # and the one-process mesh against numpy, for the whole-array reads
    if op == "full":
        np.testing.assert_array_equal(want[0]["full"].numpy(), x)
    if op == "gather":
        np.testing.assert_array_equal(want[0]["gather"].numpy(),
                                      x[:, worker.inputs(world)["positions"]])


@pytest.mark.parametrize("op", ["evaluate", "interpolate", "extend"])
def test_two_process_sharded_fft_matches_jax(groups, op):
    x = worker.fft_input().numpy().astype(np.uint32)
    n = worker.FFT_LOG
    if op == "extend":
        want_c, want_e = (np.asarray(a) for a in jfft.extend_with_coeffs(jnp.asarray(x), n, 1))
        want = {"extend_coeffs": want_c, "extend": want_e}
    else:
        fn = jfft.evaluate if op == "evaluate" else jfft.interpolate
        want = {op: np.stack([np.asarray(fn(jnp.asarray(r), n)) for r in x])}
    for rank, got in enumerate(groups[2]):
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy().astype(np.uint32), w,
                                          err_msg=f"{k} on rank {rank}")


def test_two_process_decommitment_matches_one_device(groups):
    """The batched decommitment on the process mesh: the one-device bytes
    in every process, one all_reduce and one device->host pull."""
    from stwo_brainfuck_tpu_torch.core import merkle as tmerkle

    inp = worker.decommit_inputs()
    cols = {k: torch.as_tensor(v) for k, v in inp["columns"].items()}
    want = json.dumps(tmerkle.decommit(tmerkle.commit(cols), inp["queries"]).to_json())
    x = inp["columns"][6][:, inp["positions"]]
    for rank, got in enumerate(groups[2]):
        assert got["decommit_json"] == want, f"rank {rank}"
        np.testing.assert_array_equal(got["decommit_extra"].numpy(), np.stack([x, x]))
        assert got["decommit_counts"].tolist() == [1, 1], f"rank {rank}: all_reduce, pulls"


# ---------------------------------------------------------------------------
# The CLI's prove --distributed
# ---------------------------------------------------------------------------

def _prove_argv(output) -> list:
    """The CLI prove of the small program (it logs at info by default; no
    --log, which torchrun's argument parser may take for its --log-dir:
    STWO_BF_LOG sets the level instead)."""
    return ["-m", "stwo_brainfuck_tpu_torch.cli", "prove", "--code", chip_smoke.SMALL_CODE,
            "--input", chip_smoke.SMALL_INPUT, "--output", str(output), "--device", "cpu",
            "--distributed"]


def _check_proof(path) -> None:
    with open(path) as f:
        proof = json.load(f)
    assert chip_smoke.proof_sha256(proof) == chip_smoke.REFERENCE_SHA256["small"]
    tair.verify_brainfuck(proof, device="cpu")
    jair.verify_brainfuck(proof)


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_cli_proof_is_byte_identical_to_jax(tmp_path, world):
    res = _run_group(world, lambda r: [sys.executable, *_prove_argv(tmp_path / f"rank{r}.json")])
    written = sorted(p.name for p in tmp_path.iterdir())
    assert written == ["rank0.json"], "only the coordinator writes the proof"
    assert [b"Proof written" in err for _, _, err in res] == [True] + [False] * (world - 1)
    _check_proof(tmp_path / "rank0.json")


def test_distributed_cli_under_torchrun(tmp_path):
    """The launch the CLI's docstring gives: torchrun sets WORLD_SIZE,
    RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT, and every process runs
    the same command line; STWO_BF_LOG=debug sets the log level that
    --log cannot set under torchrun (the PCS config is logged at debug)."""
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env.update({"OMP_NUM_THREADS": "1", "STWO_BF_LOG": "debug"})
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
                          "--master-port", str(_free_port()),
                          *_prove_argv(tmp_path / "proof.json")],
                         cwd=ROOT, env=env, capture_output=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr.decode()[-3000:]
    assert res.stderr.count(b"Proof written") == 1
    assert res.stderr.count(b"Circle FFT kernel launches") == 2
    assert res.stderr.count(b"Blake2s kernel launches: tree 0, level 0, grind 0") == 2
    assert res.stderr.count(b"DEBUG PCS config") == 2
    _check_proof(tmp_path / "proof.json")
