"""The interaction phase's claimed sums stay on the device until one pull.

air.prove_brainfuck takes each component's claimed sum from
framework.build_interaction_trace_async (on the mesh from
ShardedOps.interaction, the shards' scans with their carries) as a (4,)
int32 tensor on the prove's device, and pulls all thirteen with one copy
before it checks them and mixes them into the channel, in the transcript's
order. The proofs made that way of the small program and of fib19_io at
input 10 (3,043 steps, tables up to 2^12), on the one-device path, on the
D = 2 mesh in one process and by W = 2 gloo processes, are byte-identical
to the JAX package's (bench.REFERENCE_SHA256; `-m slow` recomputes
fib19_io's from the JAX package, ~4 min). Tolerance: none, sha256."""

import json
import os
import sys

import pytest
import torch

import chip_smoke
from stwo_brainfuck_tpu_torch import air, bench
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES
from stwo_brainfuck_tpu_torch.parallel.mesh import make_mesh
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine
from test_torch_multihost import _run_group

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIB = os.path.join(ROOT, "programs", "fib19_io.bf")
# name -> (CLI source arguments, input bytes)
PROGRAMS = {"small": (["--code", chip_smoke.SMALL_CODE], chip_smoke.SMALL_INPUT.encode()),
            "fib19_io_in10": (["--file", FIB], bytes([10]))}


def _machine(name: str):
    src, inp = PROGRAMS[name]
    if src[0] == "--file":
        with open(src[1]) as f:
            code = f.read()
    else:
        code = src[1]
    m = create_test_machine(compile_program(code), inp)
    m.execute()
    return m


def test_claimed_sums_are_device_tensors_pulled_once(monkeypatch):
    seen, pulls = [], []
    real_trace, real_cpu = air.build_interaction_trace_async, torch.Tensor.cpu

    def trace(*args):
        cols, claimed = real_trace(*args)
        seen.append(claimed)
        return cols, claimed

    def cpu(self, *args, **kw):
        pulls.append(self)
        return real_cpu(self, *args, **kw)

    monkeypatch.setattr(air, "build_interaction_trace_async", trace)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    proof = air.prove_brainfuck(_machine("small"), device="cpu")
    monkeypatch.undo()
    assert len(seen) == len(COMPONENT_CLASSES)
    assert all(c.dtype == torch.int32 and c.shape == (4,) for c in seen)
    assert not [t for t in pulls if any(t is c for c in seen)], "a claimed sum pulled alone"
    assert [tuple(t.shape) for t in pulls].count((len(COMPONENT_CLASSES), 4)) == 1
    assert [list(v) for v in proof["interaction_claim"].values()] == [
        [int(x) for x in c] for c in seen]
    assert chip_smoke.proof_sha256(proof) == bench.REFERENCE_SHA256["small"]


@pytest.mark.parametrize("path", ["one_device", "mesh_2", "gloo_2"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_proof_bytes_equal_the_jax_package(tmp_path, name, path):
    if path == "gloo_2":
        src, inp = PROGRAMS[name]
        _run_group(2, lambda r: [
            sys.executable, "-m", "stwo_brainfuck_tpu_torch.cli", "prove", *src, "--input",
            inp.decode(), "--output", str(tmp_path / f"rank{r}.json"), "--device", "cpu",
            "--distributed"])
        with open(tmp_path / "rank0.json") as f:
            proof = json.load(f)
    else:
        mesh = make_mesh(2, "cpu") if path == "mesh_2" else None
        proof = air.prove_brainfuck(_machine(name), device="cpu", mesh=mesh)
    assert chip_smoke.proof_sha256(proof) == bench.REFERENCE_SHA256[name]


@pytest.mark.slow
def test_fib19_io_in10_reference_is_the_jax_packages_proof():
    from stwo_brainfuck_tpu import air as jair
    from stwo_brainfuck_tpu.vm.compiler import compile_program as jcompile
    from stwo_brainfuck_tpu.vm.machine import create_test_machine as jmachine

    with open(FIB) as f:
        m = jmachine(jcompile(f.read()), bytes([10]))
    m.execute()
    proof = json.loads(json.dumps(jair.prove_brainfuck(m)))
    assert chip_smoke.proof_sha256(proof) == bench.REFERENCE_SHA256["fib19_io_in10"]
