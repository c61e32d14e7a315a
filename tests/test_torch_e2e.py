"""End to end: the port's proofs are byte-identical to the JAX package's,
each package verifies the other's proofs, the port's verifier rejects every
tamper class of tests/test_e2e.py, and the chip-smoke programs' proofs hash
to the sha256 that chip_smoke.py checks on the GPU."""

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke
from stwo_brainfuck_tpu import air as jair
from stwo_brainfuck_tpu.vm.compiler import compile_program as jcompile
from stwo_brainfuck_tpu.vm.machine import create_test_machine as jmachine
from stwo_brainfuck_tpu_torch import air as tair
from stwo_brainfuck_tpu_torch import cli as tcli
from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program as tcompile
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine as tmachine

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Two programs with the same claim (table heights), so the JAX package's
# second prove reuses the first one's compiled executables.
PROGRAMS = [("+++>,<[>+.<-]", b"\x01"), ("++>,<[>+.<-]", b"\x02")]


def _port_proof(code, inp, config=None):
    m = tmachine(tcompile(code), inp)
    m.execute()
    return tair.prove_brainfuck(m, config, device="cpu")


@pytest.fixture(scope="module")
def proofs():
    out = []
    for code, inp in PROGRAMS:
        m = jmachine(jcompile(code), inp)
        m.execute()
        out.append((jair.prove_brainfuck(m), _port_proof(code, inp)))
    return out


# proof fields in transcript order: the first that differs names the phase
FIELDS = ["config", "claim", "commitments", "interaction_claim", "sampled_values",
          "fri", "pow_nonce", "decommitments"]


@pytest.mark.parametrize("i", range(len(PROGRAMS)))
def test_port_proof_is_byte_identical_to_jax(proofs, i):
    jp, tp = proofs[i]
    for f in FIELDS:
        assert tp[f] == jp[f], f"proofs diverge at {f}"
    assert json.dumps(tp, sort_keys=True) == json.dumps(jp, sort_keys=True)
    assert json.dumps(tp) == json.dumps(jp)


@pytest.mark.parametrize("i", range(len(PROGRAMS)))
def test_each_package_verifies_the_others_proof(proofs, i):
    jp, tp = proofs[i]
    tair.verify_brainfuck(jp, device="cpu")
    jair.verify_brainfuck(json.loads(json.dumps(tp)))


def test_small_program_matches_recorded_sha256(proofs):
    assert chip_smoke.proof_sha256(proofs[0][1]) == chip_smoke.REFERENCE_SHA256["small"]


@pytest.mark.slow
def test_fib19_io_matches_recorded_sha256():
    with open(os.path.join(ROOT, "programs", "fib19_io.bf")) as f:
        proof = _port_proof(f.read(), chip_smoke.FIB_INPUT)
    assert chip_smoke.proof_sha256(proof) == chip_smoke.REFERENCE_SHA256["fib19_io"]


def _flip_root(t, byte=0, mask=1):
    def f(p):
        root = bytearray(bytes.fromhex(p["commitments"][t]))
        root[byte] ^= mask
        p["commitments"][t] = bytes(root).hex()
    return f


def _flip(path):
    def f(p):
        obj = p
        for k in path[:-1]:
            obj = obj[k] if not callable(k) else k(obj)
        obj[path[-1]] ^= 1
    return f


def _first_key(d):
    return d[next(iter(d))]


TAMPERS = {
    "claim": lambda p: p["claim"].__setitem__("memory", p["claim"]["memory"] + 1),
    "interaction_claim": _flip(["interaction_claim", "memory", 0]),
    "root0": _flip_root(0), "root1": _flip_root(1), "root2": _flip_root(2),
    "root3": _flip_root(3),
    "sampled_value": _flip(["sampled_values", 1, 0, 0, 0]),
    "composition_sample": _flip(["sampled_values", 3, 0, 0, 2]),
    "fri_last_layer": _flip(["fri", "last_layer_value", 0]),
    "fri_layer_value": _flip(["fri", "layer_values", 0, _first_key, 0]),
    "pow_nonce": lambda p: p.__setitem__("pow_nonce", p["pow_nonce"] + 1),
    "decommitment_value": _flip(["decommitments", 1, "column_values", _first_key, 0, 0]),
    "truncated": lambda p: p.pop("fri"),
    "no_decommitments": lambda p: p.__setitem__("decommitments", []),
    "value_out_of_range": lambda p: _first_key(
        p["decommitments"][1]["column_values"])[0].__setitem__(0, 2**40),
    "wrong_arity": lambda p: p["fri"]["layer_values"][0].__setitem__(
        next(iter(p["fri"]["layer_values"][0])), [1, 2, 3]),
    "log_blowup_0": lambda p: p["config"].__setitem__("log_blowup", 0),
    "n_queries_1": lambda p: p["config"].__setitem__("n_queries", 1),
    "pow_bits_0": lambda p: p["config"].__setitem__("pow_bits", 0),
    "log_max_rows_60": lambda p: p["config"].__setitem__("log_max_rows", 60),
    "log_max_rows_above_cap": lambda p: p["config"].__setitem__(
        "log_max_rows", tair.LOG_MAX_ROWS_CAP + 1),
}


@pytest.mark.parametrize("kind", sorted(TAMPERS))
def test_port_verifier_rejects_tampering(proofs, kind):
    p = copy.deepcopy(proofs[0][1])
    TAMPERS[kind](p)
    with pytest.raises(tair.VerificationError):
        tair.verify_brainfuck(p, device="cpu")


def test_port_verifier_recomputes_preprocessed_root(proofs):
    p = copy.deepcopy(proofs[0][1])
    _flip_root(0, byte=5, mask=0xFF)(p)
    with pytest.raises(tair.VerificationError, match="preprocessed"):
        tair.verify_brainfuck(p, device="cpu")


def test_fixed_ladder_top_with_unused_sizes():
    cfg = PcsConfig(log_max_rows=12, n_queries=8, pow_bits=4)
    tair.verify_brainfuck(_port_proof(*PROGRAMS[0], config=cfg), device="cpu")


def test_capacity_refusal():
    claim = {c.name: 4 for c in tair.COMPONENT_CLASSES}
    claim["memory"] = tair.LOG_MAX_ROWS_CAP + 1
    with pytest.raises(tair.ProvingError, match="capacity"):
        tair.build_layout(claim, PcsConfig(log_max_rows=0))


def test_cli_prove_and_verify_on_cpu(tmp_path, capsysbinary):
    path = str(tmp_path / "proof.json")
    assert tcli.main(["prove", "--code", PROGRAMS[0][0], "--input", "\x01",
                      "--output", path, "--device", "cpu"]) == 0
    assert tcli.main(["verify", path, "--device", "cpu"]) == 0
    with open(path) as f:
        assert chip_smoke.proof_sha256(json.load(f)) == chip_smoke.REFERENCE_SHA256["small"]


def test_cli_cuda_default_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["prove", "--code", "+.", "--output", str(tmp_path / "p.json")])


def test_verify_defaults_to_the_card(proofs):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tair.verify_brainfuck(proofs[0][1])


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import stwo_brainfuck_tpu_torch, stwo_brainfuck_tpu_torch.air, "
            "stwo_brainfuck_tpu_torch.cli, stwo_brainfuck_tpu_torch.ops.circle_fft, "
            "stwo_brainfuck_tpu_torch.ops.m31_kernels, stwo_brainfuck_tpu_torch.vm.cli, "
            "stwo_brainfuck_tpu_torch.ops.quotient_kernels, "
            "stwo_brainfuck_tpu_torch.ops.constraint_kernels, "
            "stwo_brainfuck_tpu_torch.ops.constraint_codegen, "
            "stwo_brainfuck_tpu_torch.components.device_build, "
            "stwo_brainfuck_tpu_torch.convert, stwo_brainfuck_tpu_torch.entry, "
            "stwo_brainfuck_tpu_torch.parallel.mesh, "
            "stwo_brainfuck_tpu_torch.parallel.fft_sharded, "
            "stwo_brainfuck_tpu_torch.parallel.merkle_sharded, "
            "stwo_brainfuck_tpu_torch.parallel.sharded, "
            "stwo_brainfuck_tpu_torch.parallel.prove, "
            "stwo_brainfuck_tpu_torch.parallel.multihost, stwo_brainfuck_tpu_torch.bench; "
            "import chip_smoke; "
            "assert 'stwo_brainfuck_tpu' not in sys.modules; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
