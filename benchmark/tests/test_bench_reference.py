"""The plain reference against the port's proofs on the CPU: sound proofs
pass, and a proof spoiled at each layer it carries fails."""

import copy

import pytest
import torch

import harness
from reference import commit, verify, vm
from reference.check import judge_requests
from traffic import Entry, Traffic

FIB = Traffic("fib", (Entry("fib", ",>>+<<[->[->>+<<]>[-<+>>+<]>[-<+>]<.<<]", bytes([5]), 8, 4),))
SMALL = Traffic("small", (Entry("small", "+++>,<[>+.<-]", bytes([3]), 4, 4),))
DEFAULT = {"log_blowup": 1, "n_queries": 20, "pow_bits": 10, "log_max_rows": 0}
PRODUCTION = {"log_blowup": 4, "n_queries": 30, "pow_bits": 16, "log_max_rows": 0}


def _cell(traffic, config):
    return harness.Cell("test", config, traffic, {}, [], [])


def _kept(traffic, config, seed=7, index=0):
    source, inp = traffic.request(seed, index)
    machine, proof, _ = harness.prove_request(_cell(traffic, config), source, inp, "cpu")
    claim = {k: int(v) for k, v in proof["claim"].items()}
    return harness.Kept(index, source, inp, machine.output_bytes(), len(machine.trace()), proof,
                        claim)


def _claim(kept):
    return dict(kept.claim)


@pytest.fixture(scope="module")
def small():
    return _kept(SMALL, DEFAULT)


def _judge(kept, config=DEFAULT):
    return judge_requests([kept], config, "cpu")


@pytest.mark.parametrize("traffic,config", [(SMALL, DEFAULT), (FIB, DEFAULT), (SMALL, PRODUCTION),
                                            (FIB, PRODUCTION)],
                         ids=["small-default", "fib-default", "small-production",
                              "fib-production"])
def test_sound_proofs_pass(traffic, config):
    kept = _kept(traffic, config)
    assert _judge(kept, config) == {"vm_mismatch": 0, "claim_mismatch": 0,
                                    "main_root_mismatch": 0, "rejected": 0}


def test_vm_matches_the_port_trace():
    from stwo_brainfuck_tpu_torch.vm.compiler import compile_program
    from stwo_brainfuck_tpu_torch.vm.machine import Machine

    for traffic in (SMALL, FIB):
        source, inp = traffic.request(3, 1)
        m = Machine(compile_program(source), inp)
        m.execute()
        trace, out = vm.run(vm.compile_program(source), inp)
        assert vm.compile_program(source) == compile_program(source)
        assert (trace == m.trace()).all() and out == m.output_bytes()


def _flip(v):
    return (int(v) + 1) % verify.P_INT


SPOILS = {
    "vm_output": (lambda k: setattr(k, "output", k.output[:-1] + bytes([k.output[-1] ^ 1])),
                  "vm_mismatch"),
    "vm_steps": (lambda k: setattr(k, "steps", k.steps - 1), "vm_mismatch"),
    "claim": (lambda k: k.proof["claim"].__setitem__("processor", k.proof["claim"]["processor"] + 2),
              "claim_mismatch"),
    "config": (lambda k: k.proof["config"].__setitem__("n_queries", 19), "rejected"),
    "interaction_claim": (lambda k: k.proof["interaction_claim"]["memory"].__setitem__(
        0, _flip(k.proof["interaction_claim"]["memory"][0])), "rejected"),
    "preprocessed_root": (lambda k: k.proof["commitments"].__setitem__(0, "00" * 32), "rejected"),
    "main_root": (lambda k: k.proof["commitments"].__setitem__(1, "11" * 32), "main_root_mismatch"),
    "interaction_root": (lambda k: k.proof["commitments"].__setitem__(2, "22" * 32), "rejected"),
    "composition_root": (lambda k: k.proof["commitments"].__setitem__(3, "33" * 32), "rejected"),
    "oods_main": (lambda k: k.proof["sampled_values"][1][0][0].__setitem__(
        0, _flip(k.proof["sampled_values"][1][0][0][0])), "rejected"),
    "oods_composition": (lambda k: k.proof["sampled_values"][3][2][0].__setitem__(
        1, _flip(k.proof["sampled_values"][3][2][0][1])), "rejected"),
    "fri_layer_root": (lambda k: k.proof["fri"]["layer_roots"].__setitem__(0, "44" * 32),
                       "rejected"),
    "fri_layer_value": (lambda k: _spoil_fri_value(k.proof), "rejected"),
    "fri_last_layer": (lambda k: k.proof["fri"]["last_layer_value"].__setitem__(
        0, _flip(k.proof["fri"]["last_layer_value"][0])), "rejected"),
    "pow_nonce": (lambda k: k.proof.__setitem__("pow_nonce", k.proof["pow_nonce"] + 1),
                  "rejected"),
    "decommit_value": (lambda k: _spoil_column_value(k.proof), "rejected"),
    "decommit_witness": (lambda k: k.proof["decommitments"][2]["witness_hashes"].__setitem__(
        0, "55" * 32), "rejected"),
}


def _spoil_fri_value(proof):
    lv = proof["fri"]["layer_values"][0]
    key = sorted(lv)[0]
    lv[key][0] = _flip(lv[key][0])


def _spoil_column_value(proof):
    cv = proof["decommitments"][1]["column_values"]
    level = sorted(cv)[0]
    cv[level][0][0] = _flip(cv[level][0][0])


@pytest.mark.parametrize("spoil", sorted(SPOILS))
def test_a_spoiled_proof_fails(small, spoil):
    kept = copy.deepcopy(small)
    fn, number = SPOILS[spoil]
    fn(kept)
    counts = _judge(kept)
    assert counts[number] == 1, counts


def test_a_stale_proof_fails(small):
    """The previous request's proof handed back for the next request."""
    nxt = _kept(SMALL, DEFAULT, index=1)
    stale = copy.deepcopy(nxt)
    stale.proof = copy.deepcopy(small.proof)
    counts = _judge(stale)
    assert counts["main_root_mismatch"] == 1 and counts["vm_mismatch"] == 0


@pytest.mark.gpu
def test_reference_roots_on_the_card_equal_the_cpu(small):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = verify.PcsConfig(**DEFAULT)
    ladder = verify.ladder_of(_claim(small), cfg)
    assert commit.ladder_root(ladder, 1, "cuda") == commit.ladder_root(ladder, 1, "cpu")
