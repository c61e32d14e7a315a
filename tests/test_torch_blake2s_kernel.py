"""The Blake2s kernels' schedule and wrapper on the CPU: launch_plan over
the port's tree shapes, emulate_commit (the planned steps replayed with the
plain hash_parts) against merkle.commit and the JAX package's commit, the
wrapper's refusals, the plain grind against the JAX grind, the small
program proved at pow_bits 16, the CLI's fresh-process verify and log
level, and that the port never imports jax."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stwo_brainfuck_tpu import air as jair
from stwo_brainfuck_tpu.core import merkle as jmerkle
from stwo_brainfuck_tpu.core.channel import _device_grind as jgrind
from stwo_brainfuck_tpu.core.pcs import PcsConfig as JPcsConfig
from stwo_brainfuck_tpu.vm.compiler import compile_program as jcompile
from stwo_brainfuck_tpu.vm.machine import create_test_machine as jmachine
from stwo_brainfuck_tpu_torch import air as tair
from stwo_brainfuck_tpu_torch.core import blake2s, merkle
from stwo_brainfuck_tpu_torch.core.channel import _check_pow, _device_grind
from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig
from stwo_brainfuck_tpu_torch.ops import blake2s_kernels as K
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program as tcompile
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine as tmachine

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 2**31 - 1
T = K.TAIL_LOG


# ---------------------------------------------------------------------------
# launch_plan
# ---------------------------------------------------------------------------

def _levels(*ks):
    return [("level", k, 0) for k in ks]


PLANS = {
    "one level, the root": ([(0, 3)], None, [("level", 0, 3)]),
    "one level of 2^5": ([(5, 2)], None, [("level", 5, 2), ("tail", 4, 0)]),
    "is_first ladder, a column a level": (
        [(k, 1) for k in range(21, 5, -1)], None,
        [("level", k, 1) for k in range(21, 5, -1)] + [("tail", 5, 0)]),
    "ladder with columns down to the root": (
        [(k, 1) for k in range(12, -1, -1)], None, [("level", k, 1) for k in range(12, -1, -1)]),
    "mixed sizes": ([(21, 5), (19, 30), (15, 2), (9, 4)], None,
                    [("level", 21, 5), *_levels(20), ("level", 19, 30), *_levels(18, 17, 16),
                     ("level", 15, 2), *_levels(14, 13, 12, 11), ("tail", 10, 10),
                     ("level", 9, 4), ("tail", 8, 0)]),
    "threshold - 1": ([(T - 1, 4)], None, [("level", T - 1, 4), ("tail", T - 2, 0)]),
    "threshold": ([(T, 4)], None, [("level", T, 4), ("tail", T - 1, 0)]),
    "threshold + 1": ([(T + 1, 4)], None, [("level", T + 1, 4), ("tail", T, 0)]),
    "threshold + 2": ([(T + 2, 4)], None, [("level", T + 2, 4), *_levels(T + 1), ("tail", T, 0)]),
    "a sharded top, digest-only": ([], 2, [("tail", 2, 0)]),
    "a sharded top with a column": ([(1, 3)], 2, [("tail", 2, 2), ("level", 1, 3),
                                                  ("tail", 0, 0)]),
}
# FRI layer trees: one (4, 2^m) matrix, m = 3 .. 20
PLANS.update({f"FRI layer 2^{m}": (
    [(m, 4)], None,
    [("level", m, 4), *_levels(*range(m - 1, T, -1)), ("tail", min(m - 1, T), 0)])
    for m in range(3, 21)})


@pytest.mark.parametrize("name", PLANS)
def test_launch_plan(name):
    sig, max_log, want = PLANS[name]
    plan = K.launch_plan(sig, max_log)
    assert plan == want
    # every level once, deepest first; a tail is digest-only and small
    levels = []
    for step in plan:
        if step[0] == "tail":
            assert step[1] <= T and not set(range(step[2], step[1] + 1)) & dict(sig).keys()
            levels += range(step[1], step[2] - 1, -1)
        else:
            levels.append(step[1])
            assert step[2] == dict(sig).get(step[1], 0)
    top = max(dict(sig)) if max_log is None else max_log
    assert levels == list(range(top, -1, -1))


def test_launch_plan_refuses_columns_above_its_top():
    with pytest.raises(ValueError):
        K.launch_plan([(5, 1)], 4)
    with pytest.raises(ValueError):
        K.launch_plan([])


# ---------------------------------------------------------------------------
# emulate_commit against merkle.commit (CPU) and the JAX package
# ---------------------------------------------------------------------------

TREES = {  # name: {level: n_cols}
    "one level of 2^3": {3: 4},
    "FRI layer at the threshold": {T: 4},
    "FRI layer 2^12": {12: 4},
    "mixed sizes": {12: 3, 10: 17, 9: 1, 4: 2},
    "is_first ladder": {k: 1 for k in range(12, 2, -1)},
    "wide level": {6: 40, 2: 16},
    "root with columns": {1: 2, 0: 5},
}


def _columns(tree, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, P, (c, 1 << k)).astype(np.int32) for k, c in tree.items()}


@pytest.mark.parametrize("name", TREES)
def test_emulate_commit_matches_merkle_and_jax(name):
    cols = _columns(TREES[name], len(name))
    tcols = {k: torch.as_tensor(v) for k, v in cols.items()}
    root, layers = K.emulate_commit(tcols)
    tree = merkle.commit(tcols)
    jtree = jmerkle.commit({k: jnp.asarray(v.view(np.uint32)) for k, v in cols.items()})
    assert root == tree.root == jtree.root
    assert sorted(layers) == sorted(tree.layers) == sorted(jtree.layers)
    for k, got in layers.items():
        assert got.dtype == torch.int32 and got.shape == (8, 1 << k)
        assert torch.equal(got, tree.layers[k]), f"level {k}"
        np.testing.assert_array_equal(got.numpy().view(np.uint32).T,
                                      np.asarray(jtree.layers[k]), err_msg=f"level {k}")


def test_tail_plain_writes_one_buffer():
    """A tail's levels are views of one buffer, level k at word offset
    8 * (2^k - 2^k_bottom), as the kernel writes them."""
    rng = np.random.default_rng(7)
    children = torch.as_tensor(rng.integers(0, P, (8, 1 << 5)).astype(np.int32))
    views = K.tail_plain(children, 4, 1)
    base = views[1].data_ptr()
    for k, v in views.items():
        assert v.shape == (8, 1 << k) and v.is_contiguous()
        assert v.data_ptr() - base == 4 * 8 * ((1 << k) - 2)
    prev = children
    for k in range(4, 0, -1):
        assert torch.equal(views[k], merkle.hash_level(prev, None))
        prev = views[k]


@pytest.mark.parametrize("n_bytes", [None, 40])
def test_level_plain_matches_hash_parts(n_bytes):
    rng = np.random.default_rng(11)
    words = torch.as_tensor(rng.integers(0, P, (10, 33)).astype(np.int32))
    got = K.level_plain(None, words, n_bytes)
    want = blake2s.words_to_int32(blake2s.hash_words(words, n_bytes))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The wrapper refuses what the kernels do not take, before loading
# ---------------------------------------------------------------------------

def _refusals():
    x = torch.zeros((8, 64), dtype=torch.int32)
    return {
        "a CPU tensor": (lambda: K.KERNELS.level(None, x), ValueError, "CUDA"),
        "int64 words": (lambda: K.KERNELS.level(None, x.to(torch.int64)), TypeError, "int32"),
        "a non-unit last stride": (lambda: K.KERNELS.level(x[:, ::2], None), ValueError,
                                   "stride"),
        "a tail above TAIL_LOG": (lambda: K.KERNELS.tail(x, T + 1, 0), ValueError, "outside"),
        "a CPU tail": (lambda: K.KERNELS.tail(x, 5, 0), ValueError, "CUDA"),
        "a CPU grind": (lambda: K.KERNELS.grind(bytes(32), 16, "cpu"), ValueError, "CUDA"),
    }


@pytest.mark.parametrize("what", list(_refusals()))
def test_wrapper_refuses_without_loading_the_library(what):
    call, exc, match = _refusals()[what]
    with pytest.raises(exc, match=match):
        call()
    assert K.KERNELS.lib._lib is None
    assert K.KERNELS.launches == dict.fromkeys(K.ENTRIES, 0)


# ---------------------------------------------------------------------------
# The grind and the proof at pow_bits 16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pow_bits", [14, 16])
def test_plain_grind_matches_jax(pow_bits):
    digest = np.random.default_rng(pow_bits).integers(0, 256, 32).astype(np.uint8).tobytes()
    got = _device_grind(digest, pow_bits, "cpu")
    assert got == jgrind(digest, pow_bits)
    assert _check_pow(digest, pow_bits, got)
    assert not any(_check_pow(digest, pow_bits, n) for n in range(got))


SMALL = (chip_smoke.SMALL_CODE, chip_smoke.SMALL_INPUT.encode())
POW16 = dict(log_max_rows=0, pow_bits=16)  # the CLI's prove --pow-bits 16


def _port_small_pow16() -> dict:
    m = tmachine(tcompile(SMALL[0]), SMALL[1])
    m.execute()
    return tair.prove_brainfuck(m, PcsConfig(**POW16), device="cpu")


def test_small_proof_at_pow_bits_16_matches_the_recorded_jax_sha256():
    proof = _port_small_pow16()
    assert proof["config"]["pow_bits"] == 16
    assert chip_smoke.proof_sha256(proof) == chip_smoke.REFERENCE_SHA256["small_pow16"]
    tair.verify_brainfuck(proof, device="cpu")
    jair.verify_brainfuck(proof)


@pytest.mark.slow
def test_jax_small_proof_at_pow_bits_16_has_the_recorded_sha256():
    """The JAX package's proof behind REFERENCE_SHA256["small_pow16"]
    (its first prove at this config compiles for minutes on the CPU)."""
    m = jmachine(jcompile(SMALL[0]), SMALL[1])
    m.execute()
    proof = jair.prove_brainfuck(m, JPcsConfig(**POW16))
    assert chip_smoke.proof_sha256(proof) == chip_smoke.REFERENCE_SHA256["small_pow16"]
    assert json.dumps(proof, sort_keys=True) == json.dumps(_port_small_pow16(), sort_keys=True)


# ---------------------------------------------------------------------------
# The CLI: verify in a fresh process, the log level from STWO_BF_LOG
# ---------------------------------------------------------------------------

def _cli(args, env_log=None):
    env = {k: v for k, v in os.environ.items() if k != "STWO_BF_LOG"}
    if env_log is not None:
        env["STWO_BF_LOG"] = env_log
    return subprocess.run([sys.executable, "-m", "stwo_brainfuck_tpu_torch.cli", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


@pytest.fixture(scope="module")
def small_proof_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("proof") / "small.json"
    res = _cli(["prove", "--code", SMALL[0], "--input", chip_smoke.SMALL_INPUT,
                "--output", str(path), "--device", "cpu"])
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Blake2s kernel launches: level 0, tail 0, grind 0" in res.stderr
    return path


@pytest.mark.parametrize("env_log, flag, shown", [
    (None, None, True), ("warning", None, False), ("warning", "info", True),
    ("info", "error", False)])
def test_cli_verify_in_a_fresh_process(small_proof_path, env_log, flag, shown):
    res = _cli(["verify", str(small_proof_path), "--device", "cpu",
                *(["--log", flag] if flag else [])], env_log)
    assert res.returncode == 0, res.stderr[-3000:]
    assert ("Verification OK" in res.stderr) == shown


def test_cli_verify_in_a_fresh_process_rejects_a_tamper(small_proof_path, tmp_path):
    with open(small_proof_path) as f:
        proof = json.load(f)
    assert chip_smoke.proof_sha256(proof) == chip_smoke.REFERENCE_SHA256["small"]
    proof["sampled_values"][1][0][0][0] ^= 1
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(proof))
    res = _cli(["verify", str(bad), "--device", "cpu"])
    assert res.returncode == 1
    assert "Verification FAILED" in res.stderr


# ---------------------------------------------------------------------------
# The port never imports jax
# ---------------------------------------------------------------------------

def test_port_never_imports_jax():
    """Every module of the port, found by walking the package (so a new
    module is covered without naming it), and chip_smoke.py: neither jax
    nor the JAX package is imported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import stwo_brainfuck_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "             'stwo_brainfuck_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    n = int(res.stdout.strip())
    assert n >= 40  # the package has 40 modules, ops.blake2s_kernels among them
