"""The Blake2s kernels' schedule and wrapper on the CPU: launch_plan (one
tree launch a tree) and tree_stages over the port's tree shapes,
emulate_commit (the tree kernel's stages, CTAs, counters and buffer
replayed with the plain hash_parts) and tree_plain against merkle.commit
and the JAX package's commit, every small-prove tree signature, the
sharded commit's per-shard runs against the JAX package's sharded
commit, the wrapper's refusals, the plain grind against the JAX grind, the
small program proved at pow_bits 16, the CLI's fresh-process verify and
log level, and that the port never imports jax."""

import json
import os
import subprocess
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stwo_brainfuck_tpu import air as jair
from stwo_brainfuck_tpu.core import merkle as jmerkle
from stwo_brainfuck_tpu.core.channel import _device_grind as jgrind
from stwo_brainfuck_tpu.core.pcs import PcsConfig as JPcsConfig
from stwo_brainfuck_tpu.parallel import merkle_sharded as jmerkle_sharded
from stwo_brainfuck_tpu.parallel.mesh import make_mesh as jmake_mesh
from stwo_brainfuck_tpu.vm.compiler import compile_program as jcompile
from stwo_brainfuck_tpu.vm.machine import create_test_machine as jmachine
from stwo_brainfuck_tpu_torch import air as tair
from stwo_brainfuck_tpu_torch.core import blake2s, merkle
from stwo_brainfuck_tpu_torch.core.channel import _check_pow, _device_grind
from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig
from stwo_brainfuck_tpu_torch.ops import blake2s_kernels as K
from stwo_brainfuck_tpu_torch.parallel import merkle_sharded
from stwo_brainfuck_tpu_torch.parallel.mesh import make_mesh
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program as tcompile
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine as tmachine

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 2**31 - 1
S = K.SUBTREE_LOG


# ---------------------------------------------------------------------------
# launch_plan and the tree kernel's stages
# ---------------------------------------------------------------------------

PLANS = {  # name: (signature, max_log, the one tree launch's top level)
    "one level, the root": ([(0, 3)], None, 0),
    "one level of 2^5": ([(5, 2)], None, 5),
    "is_first ladder, a column a level": ([(k, 1) for k in range(21, 5, -1)], None, 21),
    "ladder with columns down to the root": ([(k, 1) for k in range(12, -1, -1)], None, 12),
    "mixed sizes": ([(21, 5), (19, 30), (15, 2), (9, 4)], None, 21),
    # around one CTA's subtree (2^S nodes)
    "threshold - 1": ([(S - 1, 4)], None, S - 1),
    "threshold": ([(S, 4)], None, S),
    "threshold + 1": ([(S + 1, 4)], None, S + 1),
    "threshold + 2": ([(S + 2, 4)], None, S + 2),
    "a sharded top, digest-only": ([], 2, 2),
    "a sharded top with a column": ([(1, 3)], 2, 2),
}
# FRI layer trees: one (4, 2^m) matrix, m = 3 .. 20
PLANS.update({f"FRI layer 2^{m}": ([(m, 4)], None, m) for m in range(3, 21)})


@pytest.mark.parametrize("name", PLANS)
def test_launch_plan(name):
    """One launch a tree, whatever levels carry columns; its stages hash
    every level once, deepest first."""
    sig, max_log, top = PLANS[name]
    plan = K.launch_plan(sig, max_log)
    assert plan == [("tree", top)]
    stages, _ = K.tree_stages(top, H100_WAVE)
    levels = [k for t, b, _, _ in stages for k in range(t, b - 1, -1)]
    assert levels == list(range(top, -1, -1))


def test_launch_plan_refuses_columns_above_its_top():
    with pytest.raises(ValueError):
        K.launch_plan([(5, 1)], 4)
    with pytest.raises(ValueError):
        K.launch_plan([])
    with pytest.raises(ValueError):
        K.launch_plan([(K.MAX_LEVEL + 1, 1)])


H100_WAVE = K.H100_SMS * K.CTAS_A_SM
# (wave, subtree, keep): the kernel's on an H100, with every stage keeping
# 2^5 nodes a CTA or none whatever the size, and smaller subtrees whose stages cut the same
# trees at many more levels (columns at stage tops and inside stages)
SCHEDULES = ((H100_WAVE, S, K.KEEP_LOG), (0, S, K.KEEP_LOG), (1 << 30, S, K.KEEP_LOG),
             (4, 3, 1), (0, 2, 0), (0, 1, 0))


@pytest.mark.parametrize("k_top", range(K.MAX_LEVEL + 1))
def test_tree_stages(k_top):
    """What blake2s_tree checks and the kernel relies on: stage 0 starts at
    k_top; a stage's CTAs own 2^s nodes of its top and carry them up to
    2^keep if the first stage has more CTAs than the wave, else to one (the
    last stage: one CTA, at most 2^s nodes, down to the root); the next
    stage starts one level below; each stage's counters tile their own
    range."""
    for wave, s, keep in SCHEDULES if k_top <= 16 else SCHEDULES[:3]:
        stages, n_counters = K.tree_stages(k_top, wave, s, keep)
        kept = keep if 1 << stages[0][2] > wave else 0
        assert stages[0][0] == k_top and (s != S or len(stages) <= K.MAX_STAGES)
        assert stages[-1][1:3] == (0, 0) and stages[-1][0] <= s
        used = []
        for j, (top, bottom, cta_log, counter) in enumerate(stages):
            if j < len(stages) - 1:
                assert top - cta_log == s and cta_log > 0
                assert bottom - cta_log == kept
                assert stages[j + 1][0] == bottom - 1
            if j:
                used += range(counter, counter + (1 << cta_log))
        assert used == list(range(n_counters))
        levels = [k for t, b, _, _ in stages for k in range(t, b - 1, -1)]
        assert levels == list(range(k_top, -1, -1))
    assert K.tree_stages(k_top, H100_WAVE)[0][0][2] == max(0, k_top - S)


# ---------------------------------------------------------------------------
# emulate_commit and tree_plain against merkle.commit (CPU) and the JAX package
# ---------------------------------------------------------------------------

TREES = {  # name: {level: n_cols}
    "one level of 2^3": {3: 4},
    "FRI layer at the threshold": {S: 4},  # one CTA's subtree
    "FRI layer 2^12": {12: 4},
    "mixed sizes": {12: 3, 10: 17, 9: 1, 4: 2},
    "is_first ladder": {k: 1 for k in range(12, 2, -1)},
    "wide level": {6: 40, 2: 16},
    "root with columns": {1: 2, 0: 5},
    "columns at the top, middle and bottom of a run": {11: 3, 6: 20, 0: 2},
    "a 1-node tree": {0: 5},
    "a 2-node tree": {1: 3},
    "two stages, columns at stage 1's top": {S + 4: 2, 3: 1},
}


def _columns(tree, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, P, (c, 1 << k)).astype(np.int32) for k, c in tree.items()}


def _same_as_jax(layers, root, jtree):
    assert root == jtree.root
    assert sorted(layers) == sorted(jtree.layers)
    for k, got in layers.items():
        assert got.dtype == torch.int32 and got.shape == (8, 1 << k)
        np.testing.assert_array_equal(got.numpy().view(np.uint32).T,
                                      np.asarray(jtree.layers[k]), err_msg=f"level {k}")


@pytest.mark.parametrize("name", TREES)
def test_emulate_commit_matches_merkle_and_jax(name):
    cols = _columns(TREES[name], len(name))
    tcols = {k: torch.as_tensor(v) for k, v in cols.items()}
    tree = merkle.commit(tcols)
    jtree = jmerkle.commit({k: jnp.asarray(v.view(np.uint32)) for k, v in cols.items()})
    _same_as_jax(tree.layers, tree.root, jtree)
    for n, (wave, s, keep) in enumerate(SCHEDULES):
        root, layers = K.emulate_commit(tcols, wave, s, keep, seed=n)
        assert root == tree.root
        for k, got in layers.items():
            assert torch.equal(got, tree.layers[k]), f"schedule {wave, s, keep}, level {k}"


def test_emulate_commit_takes_row_slices():
    """Columns given as row slices of larger matrices (the deepest level and
    one inside the run): the kernel reads them with their row stride."""
    wide = {k - 1: v for k, v in _columns({S + 4: 7, 6: 19}, 3).items()}  # 2^(k+1) wide
    sliced = {k: torch.as_tensor(v)[2:, 1 << k:] for k, v in wide.items()}
    assert all(m.stride(0) == 2 * m.shape[1] for m in sliced.values())
    jtree = jmerkle.commit({k: jnp.asarray(v[2:, 1 << k:].view(np.uint32))
                            for k, v in wide.items()})
    tree = merkle.commit(sliced)
    _same_as_jax(tree.layers, tree.root, jtree)
    for wave, s, keep in SCHEDULES:
        root, layers = K.emulate_commit(sliced, wave, s, keep, seed=1)
        assert root == jtree.root
        assert all(torch.equal(layers[k], tree.layers[k]) for k in layers)


def _small_prove_signatures() -> list:
    sigs = []
    real = merkle.commit

    def commit(columns_by_log):
        sigs.append(tuple(sorted(((k, m.shape[0]) for k, m in columns_by_log.items()),
                                 reverse=True)))
        return real(columns_by_log)

    m = tmachine(tcompile(chip_smoke.SMALL_CODE), chip_smoke.SMALL_INPUT.encode())
    m.execute()
    with mock.patch.object(merkle, "commit", commit):
        tair.prove_brainfuck(m, device="cpu")
    return list(dict.fromkeys(sigs))


def test_every_small_prove_signature_matches_jax():
    sigs = _small_prove_signatures()
    assert len(sigs) >= 5
    for n, sig in enumerate(sigs):
        cols = _columns(dict(sig), n)
        root, layers = K.emulate_commit({k: torch.as_tensor(v) for k, v in cols.items()})
        jtree = jmerkle.commit({k: jnp.asarray(v.view(np.uint32)) for k, v in cols.items()})
        _same_as_jax(layers, root, jtree)


def test_tree_plain_writes_one_buffer():
    """A tree's levels are views of one buffer, level k at word offset
    8 * (2^k - 1), as the kernel writes them; from given children too."""
    rng = np.random.default_rng(7)
    children = torch.as_tensor(rng.integers(0, P, (8, 1 << 6)).astype(np.int32))
    cols = {3: torch.as_tensor(rng.integers(0, P, (2, 8)).astype(np.int32))}
    views = K.tree_plain(children, cols, 5)
    base = views[0].data_ptr()
    assert sorted(views) == list(range(6))
    for k, v in views.items():
        assert v.shape == (8, 1 << k) and v.is_contiguous()
        assert v.data_ptr() - base == 4 * 8 * ((1 << k) - 1)
    prev = children
    for k in range(5, -1, -1):
        assert torch.equal(views[k], K.level_plain(prev, cols.get(k)))
        prev = views[k]
    emulated = K.emulate_tree(children, cols, 5, wave=0, subtree_log=2, keep_log=1, seed=5)
    assert all(torch.equal(emulated[k], views[k]) for k in views)


@pytest.mark.parametrize("n_bytes", [None, 40])
def test_level_plain_matches_hash_parts(n_bytes):
    rng = np.random.default_rng(11)
    words = torch.as_tensor(rng.integers(0, P, (10, 33)).astype(np.int32))
    got = K.level_plain(None, words, n_bytes)
    want = blake2s.words_to_int32(blake2s.hash_words(words, n_bytes))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The sharded commit: one tree a shard, one for the top
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4, 8])
def test_commit_sharded_runs_one_tree_a_shard(d):
    """commit_sharded against the JAX package's sharded commit and the
    one-device commit; each shard's levels are one tree of its own (views
    of one buffer, as emulate_tree computes them with the levels relabelled
    k - split), and the whole commit is D + 1 tree calls."""
    tree_sig = {8: 3, 6: 2, 4: 1, 1: 2}
    cols = _columns(tree_sig, d)
    want = jmerkle_sharded.sharded_commit(
        jmake_mesh(d), {k: [v[i].view(np.uint32) for i in range(len(v))] for k, v in cols.items()})
    mesh = make_mesh(d, "cpu")
    split = mesh.split_log
    with mock.patch.object(K, "tree_plain", wraps=K.tree_plain) as spy:
        tree = merkle_sharded.commit_sharded(mesh, {k: torch.as_tensor(v) for k, v in cols.items()})
    assert spy.call_count == d + 1
    single = merkle.commit({k: torch.as_tensor(v) for k, v in cols.items()})
    assert tree.root == single.root == want
    for i in range(d):
        local = {k - split: torch.as_tensor(v)[:, i << (k - split): (i + 1) << (k - split)]
                 for k, v in cols.items() if k >= split}
        emulated = K.emulate_tree(None, local, max(tree_sig) - split, wave=0, subtree_log=2,
                                  keep_log=0, seed=i)
        base = tree.layers[split].shards[i].data_ptr()
        for k in range(max(tree_sig), split - 1, -1):
            got = tree.layers[k].shards[i]
            assert got.data_ptr() - base == 4 * 8 * ((1 << (k - split)) - 1)
            assert torch.equal(got, emulated[k - split]), f"shard {i}, level {k}"
            assert torch.equal(got, single.layers[k][:, i << (k - split): (i + 1) << (k - split)])
    for k in range(split - 1, -1, -1):
        assert torch.equal(tree.layers[k], single.layers[k])


# ---------------------------------------------------------------------------
# The wrapper refuses what the kernels do not take, before loading
# ---------------------------------------------------------------------------

def _refusals():
    x = torch.zeros((8, 64), dtype=torch.int32)
    x5 = torch.zeros((2, 32), dtype=torch.int32)
    return {
        "a CPU tensor": (lambda: K.KERNELS.level(None, x), ValueError, "CUDA"),
        "int64 words": (lambda: K.KERNELS.level(None, x.to(torch.int64)), TypeError, "int32"),
        "a non-unit last stride": (lambda: K.KERNELS.level(x[:, ::2], None), ValueError,
                                   "stride"),
        "a tree above MAX_LEVEL": (lambda: K.KERNELS.tree(None, {}, K.MAX_LEVEL + 1), ValueError,
                                   "outside"),
        "a CPU tree": (lambda: K.KERNELS.tree(None, {5: x5}, 5), ValueError, "CUDA"),
        "a CPU grind": (lambda: K.KERNELS.grind(bytes(32), 16, "cpu"), ValueError, "CUDA"),
        "tree columns above its top": (lambda: K.KERNELS.tree(None, {5: x5}, 4), ValueError,
                                       "outside"),
        "a tree's deepest level without a message": (
            lambda: K.KERNELS.tree(None, {5: x5}, 6), ValueError, "no children and no columns"),
        "tree children of the wrong width": (lambda: K.KERNELS.tree(x, {}, 4), ValueError,
                                             "children of shape"),
        "int64 tree columns": (lambda: K.KERNELS.tree(None, {5: x5.to(torch.int64)}, 5),
                               TypeError, "int32"),
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
    assert "Blake2s kernel launches: tree 0, level 0, grind 0" in res.stderr
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
