"""Whole proves on a mesh of CPU shards: the port's mesh proof of the small
program is byte-identical to the JAX package's one-device proof for 1, 2
and 8 shards and verified by both packages; the CLI's --devices and the
port's entry points (entry, dryrun_multichip) run the same path;
--distributed (tests/test_torch_multihost.py) does not combine with
--devices."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from stwo_brainfuck_tpu import air as jair
from stwo_brainfuck_tpu.components import defs as jdefs
from stwo_brainfuck_tpu.components import tables as jtables
from stwo_brainfuck_tpu.framework import component as jfw
from stwo_brainfuck_tpu.vm.compiler import compile_program as jcompile
from stwo_brainfuck_tpu.vm.machine import create_test_machine as jmachine
from stwo_brainfuck_tpu_torch import air as tair
from stwo_brainfuck_tpu_torch import cli as tcli
from stwo_brainfuck_tpu_torch import convert, entry
from stwo_brainfuck_tpu_torch.parallel.mesh import make_mesh
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program as tcompile
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine as tmachine

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODE, INPUT = chip_smoke.SMALL_CODE, chip_smoke.SMALL_INPUT.encode()


@pytest.fixture(scope="module")
def jax_proof():
    m = jmachine(jcompile(CODE), INPUT)
    m.execute()
    return jair.prove_brainfuck(m)


def _mesh_proof(code, inp, n_devices):
    m = tmachine(tcompile(code), inp)
    m.execute()
    return tair.prove_brainfuck(m, device="cpu", mesh=make_mesh(n_devices, "cpu"))


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_mesh_proof_is_byte_identical_to_jax(jax_proof, n_devices):
    proof = _mesh_proof(CODE, INPUT, n_devices)
    for field in jax_proof:
        assert proof[field] == jax_proof[field], f"proofs diverge at {field}"
    assert json.dumps(proof) == json.dumps(jax_proof)
    tair.verify_brainfuck(proof, device="cpu")
    jair.verify_brainfuck(json.loads(json.dumps(proof)))


def test_cli_devices_proof_equals_the_one_device_proof(tmp_path, capsysbinary):
    paths = {}
    for flags in ([], ["--devices", "2"]):
        path = str(tmp_path / f"proof{len(flags)}.json")
        assert tcli.main(["prove", "--code", CODE, "--input", chip_smoke.SMALL_INPUT,
                          "--output", path, "--device", "cpu", "--log", "warning", *flags]) == 0
        paths[len(flags)] = path
    with open(paths[0]) as f0, open(paths[2]) as f2:
        assert f0.read() == f2.read()
    assert tcli.main(["verify", paths[2], "--device", "cpu", "--log", "warning"]) == 0


def test_cli_refuses_a_mesh_that_is_not_a_power_of_two(tmp_path, capsysbinary):
    with pytest.raises(ValueError, match="power-of-two"):
        tcli.main(["prove", "--code", CODE, "--input", chip_smoke.SMALL_INPUT, "--output",
                   str(tmp_path / "p.json"), "--device", "cpu", "--devices", "3"])


def test_cli_refuses_distributed_with_devices(tmp_path, capsys):
    with pytest.raises(SystemExit):
        tcli.main(["prove", "--code", CODE, "--output", str(tmp_path / "p.json"),
                   "--device", "cpu", "--distributed", "--devices", "2"])
    assert "not allowed with argument" in capsys.readouterr().err


def test_dryrun_multichip_on_cpu(capsys):
    entry.dryrun_multichip(4, "cpu")
    assert "byte-identical" in capsys.readouterr().out


def test_entry_matches_jax_interaction():
    fn, args = entry.entry("cpu")
    cols, claimed = fn(*args)
    m = jmachine(jcompile(CODE), INPUT)
    m.execute()
    tabs = jtables.all_tables(m.trace(), m.program())["memory"]
    log_size = int(np.log2(len(next(iter(tabs.values())))))
    els = {k: jfw.LookupElements.dummy(s) for k, s in jdefs.ELEMENT_SIZES.items()}
    want_cols, want_claimed = jfw.build_interaction_trace(
        jdefs.MemoryComponent(log_size), {k: np.asarray(v) for k, v in tabs.items()}, els)
    assert claimed == tuple(want_claimed)
    for got, want in zip(cols, want_cols):
        np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


@pytest.mark.slow
def test_fib19_io_mesh_proof_matches_recorded_sha256():
    with open(os.path.join(ROOT, "programs", "fib19_io.bf")) as f:
        proof = _mesh_proof(f.read(), chip_smoke.FIB_INPUT, 4)
    assert chip_smoke.proof_sha256(proof) == chip_smoke.REFERENCE_SHA256["fib19_io"]
