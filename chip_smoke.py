"""Smoke run of the torch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device report: the card's name, power limit and clocks, CUDA version,
     kernel build time (both kernel libraries are built with nvcc from
     stwo_brainfuck_tpu_torch/csrc/ into stwo_brainfuck_tpu_torch/build/,
     one nvcc per source, started together), and the SASS instruction
     counts of one M31 product, m31::mul and the FFT's m31::mul_doubled
     (cuobjdump), which set the instruction-dispatch bounds;
  2. the circle FFT kernel against its plain torch version on the card, bit
     for bit, for evaluate and interpolate (FFT_SIZES, 1 and 8 columns) and
     the fused extend at blowups 1-4 up to a 2^25 extension through
     core.fft.extend_with_coeffs (launches exactly its plan, no plain FFT,
     nothing allocated beyond its two outputs); then both versions at the
     main path's shapes (FFT_SHAPES), compared and timed, beside each
     shape's byte and dispatch bounds;
  3. the three M31 kernels against their plain versions on the card, bit
     for bit, at 1 .. 2^24 elements with edge values and a broadcast case,
     mul_chain at chain 1, 8 and 13, and times at 2^24 beside the bounds;
     then one compute-bound reading, mul_chain of 256 products at 2^24,
     against the dispatch bound's product rate (the FFT shapes' times are
     printed after it, with their dispatch bound at that rate beside);
  4. the M31 path, counts set to 0 first: the module's mul, mul_add and
     mul_chain at 2^24, then throughput_benchmark(24) (kernel and plain
     Gmul/s beside the bound). Each kernel's count must show its launches
     and the plain guard only the benchmark's own plain calls;
  5. the device table build against the host builders on the card, bit for
     bit, for the small program, fib19_io and big22;
  6. the mesh prover (stwo_brainfuck_tpu_torch/parallel/, D shards sharing
     the one card): the sharded evaluate, interpolate and extend (D 2, 4, 8;
     n 16, 20, 24; 1 and 8 columns) against the one-device kernel and the
     plain version, bit for bit, and one sharded evaluate (4, 2^24) at D = 4
     timed beside the one-device kernel's; then, counts set to 0 first, the
     small program through the CLI with --devices 8 (sha256, tamper) and
     fib19_io at D = 2 and 4 (sha256, verify), each with its per-phase
     split, peak device memory and FFT launches, no plain FFT on a CUDA
     tensor and no M31 kernel;
  7. the prover's main path, counts set to 0 first: the small program
     through the CLI entry point (prove, verify, proof sha256 against the
     JAX package's, a tampered copy rejected), then fib19_io
     (programs/fib19_io.bf, input 19: 223,689 steps; prove once cold, twice
     warm, verify, sha256) and programs/big22.bf (1.32 M steps, 2^22-row
     tables), each with its per-phase split and peak device memory. After
     each prove the FFT kernel's launch count must have risen, the plain
     FFT must not have run on a CUDA tensor and no M31 kernel or plain M31
     op may have run.
The last line of stdout is the JSON result; the line before it lists the
kernels, the one before that names the card. Needs no jax.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import io
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from stwo_brainfuck_tpu_torch import air, cli
from stwo_brainfuck_tpu_torch.components import device_build, tables
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES
from stwo_brainfuck_tpu_torch.core import fft
from stwo_brainfuck_tpu_torch.core import fri, quotients
from stwo_brainfuck_tpu_torch.ops import circle_fft, m31_kernels, nvcc
from stwo_brainfuck_tpu_torch.parallel import fft_sharded
from stwo_brainfuck_tpu_torch.parallel import prove as sharded_prove
from stwo_brainfuck_tpu_torch.parallel.mesh import make_mesh
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine

ROOT = os.path.dirname(os.path.abspath(__file__))

# sha256 of json.dumps(proof, sort_keys=True) of the JAX package's proofs
# (stwo_brainfuck_tpu.air.prove_brainfuck, default config, JAX on the CPU).
REFERENCE_SHA256 = {
    "small": "ff791b1d69f378cb26ffaba5fd7e5ef59e375e60a39e6ae89333ec77b3994b52",
    "fib19_io": "05c19f764ada70a3d6b8bc814d24bc6baf50cf1bde7ca979242eb61de4950860",
}
SMALL_CODE = "+++>,<[>+.<-]"
SMALL_INPUT = "\x01"
FIB_INPUT = bytes([19])

FFT_SIZES = (4, 11, 16, 17, 20, 22, 23, 24)
# extends are checked up to a 2^25 extension: only n = 24 runs the fused
# pass on 2^14-element tiles (radix 5)
EXTEND_MAX_LOG = 25
# the main path's shapes, timed: (op, columns, n, log_blowup)
FFT_SHAPES = (("evaluate", 4, 24, 0), ("interpolate", 4, 23, 0), ("extend", 8, 19, 1),
              ("extend", 8, 19, 4), ("extend", 40, 22, 1))
# the mesh prover's checks: shard counts and sizes of the sharded transforms
SHARDED_MESHES = (2, 4, 8)
SHARDED_SIZES = (16, 20, 24)
M31_SIZES = (1, 127, 128, 4097, 1 << 20, 1 << 24)
M31_EDGES = (0, 1, 2**16 - 1, 2**16, 2**31 - 2)
P = 2**31 - 1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)


def proof_sha256(proof: dict) -> str:
    return hashlib.sha256(json.dumps(proof, sort_keys=True).encode()).hexdigest()


def _line(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj)}", flush=True)


def _time_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def _sass_functions(lib: nvcc.CudaLibrary) -> dict:
    """Function name -> its SASS opcodes (NOPs left out), from cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib.path())],
                         capture_output=True, text=True, check=True).stdout
    funcs: dict = {}
    name = None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None and m.group(1) != "NOP":
            funcs[name].append(m.group(1))
    return funcs


def _sass_ops(funcs: dict, tag: str) -> list:
    hits = [f for f in funcs if tag in f]
    if len(hits) != 1:
        raise AssertionError(f"SASS: {tag} matches {hits} of {sorted(funcs)}")
    return funcs[hits[0]]


def sass_per_mul() -> dict:
    """SASS instructions of one M31 product of each kind.
    per_mul, m31::mul (the M31 kernels, the interpolate's scale): the
    chain-of-8 kernel and the mul kernel differ only in 7 more products per
    element, in the 4-wide vector body and in the scalar tail (35 in all);
    the min-instruction counts (one per product) show that structure.
    fft_per_mul, m31::mul_doubled (the FFT's butterflies): the circle FFT
    library's two mul_doubled_probe instantiations differ only in 8 more
    products."""
    funcs = _sass_functions(m31_kernels.KERNELS.lib)
    mul, chain8 = _sass_ops(funcs, "5MulOpE"), _sass_ops(funcs, "ChainOpILi8E")
    per_mul = (len(chain8) - len(mul)) / 35
    funcs = _sass_functions(circle_fft.KERNEL.lib)
    one, nine = (_sass_ops(funcs, f"mul_doubled_probeILi{k}E") for k in (1, 9))
    fft_per_mul = (len(nine) - len(one)) / 8
    if per_mul <= 0 or fft_per_mul <= 0:
        raise AssertionError(f"SASS: {len(chain8)} chain-8 vs {len(mul)} mul instructions, "
                             f"{len(nine)} vs {len(one)} in the mul_doubled probes")
    return {"per_mul": per_mul, "mul_instructions": len(mul),
            "chain8_instructions": len(chain8),
            "mul_min_ops": sum("MNMX" in o for o in mul),
            "chain8_min_ops": sum("MNMX" in o for o in chain8),
            "fft_per_mul": fft_per_mul, "probe1_instructions": len(one),
            "probe9_instructions": len(nine)}


def bound(nbytes: float, instructions: float, dispatch_per_s: float) -> dict:
    """The least time for the work: bytes over the device-memory rate, or
    integer instructions over the card's dispatch rate, whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    dispatch_ms = instructions / dispatch_per_s * 1e3
    return {"bound_ms": max(bytes_ms, dispatch_ms),
            "bound_by": "bytes" if bytes_ms >= dispatch_ms else "operations",
            "bytes_bound_ms": bytes_ms, "dispatch_bound_ms": dispatch_ms}


def fft_bound(op: str, cols: int, n: int, blowup: int, sass: dict,
              dispatch_per_s: float) -> dict:
    """The FFT shape's bounds: bytes = each input read once and each output
    written once (an extend reads the values and writes the coefficients
    and the extension); instructions = butterflies of one m31::mul_doubled
    product (fft_per_mul), one add and one subtract (2 instructions each),
    plus one m31::mul (per_mul) an element for the interpolate's scale. An
    extend counts no butterflies in the top `blowup` forward stages: their
    second input is exactly zero."""
    size = cols << n
    butterfly = sass["fft_per_mul"] + 4
    if op == "evaluate":
        return bound(8 * size, n * (size // 2) * butterfly, dispatch_per_s)
    inverse = n * (size // 2) * butterfly + size * sass["per_mul"]
    if op == "interpolate":
        return bound(8 * size, inverse, dispatch_per_s)
    return bound(4 * (2 * size + (size << blowup)),
                 inverse + (n * (size // 2) << blowup) * butterfly, dispatch_per_s)


def phase_kernel(sass: dict, dispatch_per_s: float) -> dict:
    """The kernel vs its plain version on the same CUDA tensors, bit for
    bit, then both versions' times at the main path's shapes (each also
    compared) beside the bounds."""
    rng = np.random.default_rng(0)
    p = 2**31 - 1
    max_err = 0
    checked = 0
    guard = fft.PLAIN_CUDA_CALLS

    def same(got, want, what):
        nonlocal max_err, checked
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"circle FFT kernel != plain: {what}")
        checked += 1

    plain_calls = 0
    for n in FFT_SIZES:
        for cols in (1, 8):
            x = torch.as_tensor(rng.integers(0, p, (cols, 1 << n)).astype(np.int32),
                                device="cuda")
            same(circle_fft.evaluate(x, n), fft.evaluate_plain(x, n), f"evaluate n={n} C={cols}")
            same(circle_fft.interpolate(x, n), fft.interpolate_plain(x, n),
                 f"interpolate n={n} C={cols}")
            plain_calls += 2
            for blowup in (1, 2, 3, 4):
                if n + blowup > EXTEND_MAX_LOG:
                    continue
                # the prover's entry point: the fused kernel launches only
                # its own plan and allocates the two outputs, no padding
                circle_fft.twiddle_table(n, True, str(x.device))
                circle_fft.twiddle_table(n + blowup, False, str(x.device))
                torch.cuda.synchronize()
                launches = circle_fft.KERNEL.launches
                calls = fft.PLAIN_CUDA_CALLS
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                c, e = fft.extend_with_coeffs(x, n, blowup)
                torch.cuda.synchronize()
                grown = torch.cuda.max_memory_allocated() - base
                if circle_fft.KERNEL.launches - launches != len(
                        circle_fft.launch_plan("extend", n, cols, blowup)):
                    raise AssertionError(f"extend n={n}: launches differ from its plan")
                if fft.PLAIN_CUDA_CALLS != calls:
                    raise AssertionError(f"extend n={n}: the plain FFT ran on a CUDA tensor")
                outputs = sum(-(-t.untyped_storage().nbytes() // 512) * 512 for t in (c, e))
                if grown > outputs:
                    raise AssertionError(f"extend n={n}: {grown} B allocated beyond its outputs")
                cp, ep = fft.extend_plain(x, n, blowup)
                plain_calls += 2
                same(c, cp, f"extend coeffs n={n} C={cols} blowup={blowup}")
                same(e, ep, f"extend n={n} C={cols} blowup={blowup}")
                del c, e, cp, ep
            del x
    torch.cuda.synchronize()
    if fft.PLAIN_CUDA_CALLS - guard != plain_calls:
        raise AssertionError("the plain FFT ran on a CUDA tensor outside the named calls")

    times = {}
    for op, cols, n, blowup in FFT_SHAPES:
        x = torch.as_tensor(rng.integers(0, p, (cols, 1 << n)).astype(np.int32), device="cuda")
        if op == "evaluate":
            k, pl = (lambda: circle_fft.evaluate(x, n)), (lambda: fft.evaluate_plain(x, n))
        elif op == "interpolate":
            k, pl = (lambda: circle_fft.interpolate(x, n)), (lambda: fft.interpolate_plain(x, n))
        else:
            k = lambda: fft.extend_with_coeffs(x, n, blowup)  # noqa: E731
            pl = lambda: fft.extend_plain(x, n, blowup)  # noqa: E731
        key = f"{op} ({cols}, 2^{n})" + (f" blowup {blowup}" if blowup else "")
        got, want = k(), pl()
        if op != "extend":
            got, want = (got,), (want,)
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{key}, output {i}")
        del got, want, g, w
        launches = len(circle_fft.launch_plan(op, n, cols, blowup))
        times[key] = {"kernel_ms": _time_ms(k, reps=10), "plain_ms": _time_ms(pl, reps=2),
                      "launches": launches,
                      **fft_bound(op, cols, n, blowup, sass, dispatch_per_s)}
        del x
        torch.cuda.empty_cache()
    # the plain versions' int64 stages and the kernel's tables of every
    # size above: the prover builds its own
    fft.get_twiddles.cache_clear()
    circle_fft.twiddle_table.cache_clear()
    torch.cuda.empty_cache()
    _line("kernel_check", {"sizes": FFT_SIZES, "cols": [1, 8], "extend_blowups": [1, 2, 3, 4],
                           "extend_max_log": EXTEND_MAX_LOG, "timed_shapes": len(FFT_SHAPES),
                           "comparisons": checked, "tolerance": 0, "max_abs_err": max_err})
    return {"max_abs_err": max_err, "times": times}


def phase_sharded_fft() -> dict:
    """The sharded transforms with D shards on the card against the
    one-device kernel and the plain version on the same CUDA tensors, bit
    for bit (each reference computed once per shape), then one sharded
    evaluate (4, 2^24) at D = 4 timed beside the one-device kernel's."""
    rng = np.random.default_rng(2)
    p = 2**31 - 1
    max_err = 0
    checked = 0
    guard = fft.PLAIN_CUDA_CALLS
    plain_calls = 0
    meshes = {d: make_mesh(d, "cuda") for d in SHARDED_MESHES}

    def same(got, want, what):
        nonlocal max_err, checked
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"sharded circle FFT != reference: {what}")
        checked += 1

    for n in SHARDED_SIZES:
        for shape in ((1 << n,), (8, 1 << n)):
            x = torch.as_tensor(rng.integers(0, p, shape).astype(np.int32), device="cuda")
            refs = {"evaluate": (circle_fft.evaluate(x, n), fft.evaluate_plain(x, n)),
                    "interpolate": (circle_fft.interpolate(x, n), fft.interpolate_plain(x, n))}
            coeffs, ext = fft.extend_with_coeffs(x, n, 1)
            coeffs_p, ext_p = fft.extend_plain(x, n, 1)
            refs["extend coeffs"], refs["extend"] = (coeffs, coeffs_p), (ext, ext_p)
            plain_calls += 4
            del coeffs, ext, coeffs_p, ext_p
            for d, mesh in meshes.items():
                before = circle_fft.KERNEL.launches
                got = {"evaluate": fft_sharded.make_sharded_evaluate(mesh, n)(x),
                       "interpolate": fft_sharded.make_sharded_interpolate(mesh, n)(x)}
                got["extend coeffs"], got["extend"] = fft_sharded.sharded_extend(mesh, x, n, 1)
                local = n - mesh.split_log
                plan = sum(len(circle_fft.launch_plan(op, m, 1)) for op, m in (
                    ("evaluate", local), ("interpolate", local), ("interpolate", local),
                    ("evaluate", local + 1)))
                if circle_fft.KERNEL.launches - before != d * plan:
                    raise AssertionError(f"sharded FFT D={d} n={n}: launches differ from the "
                                         f"shards' plans")
                for op, arr in got.items():
                    for ref, kind in zip(refs[op], ("kernel", "plain")):
                        same(arr.full(), ref, f"{op} D={d} n={n} shape={shape} vs {kind}")
                del got
            del x, refs
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    if fft.PLAIN_CUDA_CALLS - guard != plain_calls:
        raise AssertionError("the plain FFT ran on a CUDA tensor outside the named calls")

    mesh = meshes[4]
    x = torch.as_tensor(rng.integers(0, p, (4, 1 << 24)).astype(np.int32), device="cuda")
    xs = mesh.shard(x)
    sharded_eval = fft_sharded.make_sharded_evaluate(mesh, 24)
    same(sharded_eval(xs).full(), circle_fft.evaluate(x, 24), "timed shape")
    times = {"shape": "evaluate (4, 2^24)", "shards": 4,
             "sharded_ms": _time_ms(lambda: sharded_eval(xs), reps=10),
             "one_device_ms": _time_ms(lambda: circle_fft.evaluate(x, 24), reps=10)}
    del x, xs
    torch.cuda.empty_cache()
    _line("sharded_fft_check", {
        "shards": SHARDED_MESHES, "sizes": SHARDED_SIZES, "cols": [1, 8], "extend_blowup": 1,
        "comparisons": checked, "tolerance": 0, "max_abs_err": max_err, "times": times})
    return {"max_abs_err": max_err, "times": times}


def _clear_prover_caches() -> None:
    """Drop every cached device tensor the provers keep (twiddle tables,
    domain points, fold twiddles, the ladder tree, the mesh's gathers), so
    that a cold prove builds its own and its peak counts only them."""
    for cached in (fft.get_twiddles, circle_fft.twiddle_table, circle_fft.shard_twiddle_table,
                   sharded_prove._permutation, air._preprocessed_tree, fri._fold_itw,
                   quotients.domain_points_storage):
        cached.cache_clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _reset_counts() -> None:
    circle_fft.KERNEL.launches = 0
    fft.PLAIN_CUDA_CALLS = 0
    m31_kernels.KERNELS.launches = dict.fromkeys(m31_kernels.KINDS, 0)
    m31_kernels.PLAIN_CUDA_CALLS = 0


def _check_launches(before: int, what: str) -> int:
    launched = circle_fft.KERNEL.launches - before
    if launched <= 0:
        raise AssertionError(f"{what}: the circle FFT kernel was not launched")
    if fft.PLAIN_CUDA_CALLS:
        raise AssertionError(f"{what}: the plain FFT ran on a CUDA tensor")
    if any(m31_kernels.KERNELS.launches.values()) or m31_kernels.PLAIN_CUDA_CALLS:
        raise AssertionError(f"{what}: an M31 kernel or plain M31 op ran on the prover path")
    return launched


def phase_small(tag: str = "small", flags: tuple = ()) -> int:
    """The small program through the CLI entry point (`flags`: more prove
    arguments, such as --devices)."""
    before = circle_fft.KERNEL.launches
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "proof.json")
        out = io.TextIOWrapper(io.BytesIO())  # the program's '.' output
        with contextlib.redirect_stdout(out):
            rc = cli.main(["prove", "--code", SMALL_CODE, "--input", SMALL_INPUT,
                           "--output", path, "--device", "cuda", "--log", "warning", *flags])
        if rc != 0:
            raise AssertionError(f"CLI prove exited {rc}")
        launched = _check_launches(before, f"{tag} prove")
        with open(path) as f:
            proof = json.load(f)
        sha = proof_sha256(proof)
        if sha != REFERENCE_SHA256["small"]:
            raise AssertionError(f"small proof sha256 {sha} != JAX reference")
        if cli.main(["verify", path, "--device", "cuda", "--log", "warning"]) != 0:
            raise AssertionError("CLI verify rejected the small proof")
        bad = copy.deepcopy(proof)
        bad["sampled_values"][1][0][0][0] ^= 1
        with open(path, "w") as f:
            json.dump(bad, f)
        logging.disable(logging.ERROR)  # the expected "Verification FAILED"
        try:
            rejected = cli.main(["verify", path, "--device", "cuda"]) == 1
        finally:
            logging.disable(logging.NOTSET)
        if not rejected:
            raise AssertionError("CLI verify accepted a tampered proof")
    _line(tag, {"flags": list(flags), "sha256": sha, "matches_jax": True,
                "tamper_rejected": True, "fft_launches": launched})
    return launched


def phase_program(name, path, inp, runs: int, expect_sha: str | None,
                  n_shards: int = 0) -> int:
    """Prove (`runs` times, the first cold) and verify one program; on a
    mesh of `n_shards` shards over the visible cards if n_shards > 0."""
    with open(path) as f:
        code = compile_program(f.read())
    mesh = make_mesh(n_shards, "cuda") if n_shards else None
    tag = {"shards": n_shards, "devices": sorted({str(d) for d in mesh.devices})} if mesh else {}
    launched = 0
    for run in range(runs):
        machine = create_test_machine(code, inp)
        t0 = time.perf_counter()
        machine.execute()
        steps = len(machine.trace())
        torch.cuda.reset_peak_memory_stats()
        before = circle_fft.KERNEL.launches
        timer = air.PhaseTimer("cuda")
        t1 = time.perf_counter()
        proof = air.prove_brainfuck(machine, device="cuda", timer=timer, mesh=mesh)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t1
        launched = _check_launches(before, f"{name} prove")
        peak = torch.cuda.max_memory_allocated()
        t2 = time.perf_counter()
        air.verify_brainfuck(proof, device="cuda")
        verify_s = time.perf_counter() - t2
        sha = proof_sha256(proof)
        if expect_sha is not None and sha != expect_sha:
            raise AssertionError(f"{name} proof sha256 {sha} != JAX reference")
        _line("sharded" if mesh else name, {
            **({"program": name, **tag} if mesh else {}),
            "run": "cold" if run == 0 else "warm", "vm": machine.vm, "steps": steps,
            "vm_s": t1 - t0, "prove_s": prove_s, "verify_s": verify_s,
            "khz": steps / prove_s / 1e3, "proof_bytes": len(json.dumps(proof)),
            "claim_max_log": max(proof["claim"].values()),
            "phases_s": timer.seconds, "peak_device_bytes": peak,
            "fft_launches": launched, "sha256": sha,
            "matches_jax": None if expect_sha is None else True,
        })
        del proof
        torch.cuda.empty_cache()
    return launched


def _m31_values(rng, n: int, spread: str) -> torch.Tensor:
    """n random canonical values on the card, the first 25 every pair of
    edge values (a takes them repeated, b and c tiled)."""
    x = rng.integers(0, P, n).astype(np.int32)
    e = np.array(M31_EDGES, np.int32)
    k = min(n, e.size ** 2)
    x[:k] = (np.repeat(e, e.size) if spread == "repeat" else np.tile(e, e.size))[:k]
    return torch.as_tensor(x, device="cuda")


def phase_m31(per_mul: float, dispatch_per_s: float) -> dict:
    """The three M31 kernels vs their plain versions on the same CUDA
    tensors, bit for bit, then both versions' times at 2^24."""
    K = m31_kernels
    rng = np.random.default_rng(1)
    launches0, guard0 = dict(K.KERNELS.launches), K.PLAIN_CUDA_CALLS
    max_err = dict.fromkeys(K.KINDS, 0)
    checks = 0
    wants = {}

    def check(kind, got, want, what):
        nonlocal checks
        checks += 1
        if got.shape != want.shape:
            raise AssertionError(f"M31 {kind}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err[kind] = max(max_err[kind], err)
        if err:
            raise AssertionError(f"M31 {kind} kernel != plain at {what}")

    cases = [(n, _m31_values(rng, n, "repeat"), _m31_values(rng, n, "tile"),
              _m31_values(rng, n, "tile")) for n in M31_SIZES]
    cases.append(("broadcast (4097, 1) x (1, 128) + (128,)",
                  _m31_values(rng, 4097, "repeat").reshape(-1, 1),
                  _m31_values(rng, 128, "tile")[None, :], _m31_values(rng, 128, "tile")))
    for what, a, b, c in cases:
        check("mul", K.mul(a, b), K.mul_plain(a, b), what)
        check("mul_add", K.mul_add(a, b, c), K.mul_add_plain(a, b, c), what)
        for chain in (1, 8, 13):
            check("mul_chain", K.mul_chain(a, b, chain), K.mul_chain_plain(a, b, chain),
                  f"{what}, chain {chain}")
        if what == 1 << 24:
            big = (a, b, c)
            wants = {"mul": K.mul_plain(a, b), "mul_add": K.mul_add_plain(a, b, c),
                     "mul_chain": K.mul_chain_plain(a, b, 8)}
    torch.cuda.synchronize()
    launched = {k: K.KERNELS.launches[k] - launches0[k] for k in K.KINDS}
    expect = {"mul": len(cases), "mul_add": len(cases), "mul_chain": 3 * len(cases)}
    if launched != expect:
        raise AssertionError(f"M31 comparison launched {launched}, expected {expect}")
    if K.PLAIN_CUDA_CALLS - guard0 != checks + len(wants):
        raise AssertionError("a plain M31 op ran on a CUDA tensor outside the named calls")
    _line("m31_check", {"sizes": M31_SIZES, "broadcast": True, "chains": [1, 8, 13],
                        "edge_values": M31_EDGES, "comparisons": checks,
                        "tolerance": 0, "max_abs_err": max_err})

    a, b, c = big
    n = a.numel()
    work = {  # kind: (kernel, plain, bytes moved, integer instructions)
        "mul": (lambda: K.mul(a, b), lambda: K.mul_plain(a, b), 12 * n, n * per_mul),
        "mul_add": (lambda: K.mul_add(a, b, c), lambda: K.mul_add_plain(a, b, c),
                    16 * n, n * (per_mul + 2)),
        "mul_chain": (lambda: K.mul_chain(a, b, 8), lambda: K.mul_chain_plain(a, b, 8),
                      12 * n, 8 * n * per_mul),
    }
    times = {}
    for kind, (kern, plain, nbytes, instr) in work.items():
        times[kind] = {"kernel_ms": _time_ms(kern, reps=20), "plain_ms": _time_ms(plain, reps=5),
                       **bound(nbytes, instr, dispatch_per_s)}
    _line("m31_times", {"n": n, "chain": 8, **times})

    # one compute-bound reading: a chain of 256 products an element moves
    # 12 bytes for 256 products, so the integer issue rate, not memory,
    # sets its time. The dispatch bounds assume one warp instruction per
    # scheduler and clock for every instruction.
    chain = 256
    chain_ms = _time_ms(lambda: K.mul_chain(a, b, chain), reps=5)
    rate = chain * n / (chain_ms / 1e3)
    share = rate / (dispatch_per_s / per_mul)
    _line("m31_issue_rate", {"n": n, "chain": chain, "kernel_ms": chain_ms,
                             "gmul_s": rate / 1e9,
                             "dispatch_bound_gmul_s": dispatch_per_s / per_mul / 1e9,
                             "share_of_dispatch_bound": share})
    return {"max_abs_err": max_err, "times": times, "big": big, "wants": wants,
            "issue_share": share}


def phase_tables(programs) -> dict:
    """Device tables vs the host builders on the card, bit for bit."""
    out = {}
    for name, code, inp in programs:
        m = create_test_machine(compile_program(code), inp)
        m.execute()
        trace, program = m.trace(), m.program()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = device_build.build_meta(trace, program)
        t1 = time.perf_counter()
        mats = device_build.build_device_tables(trace, meta, "cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host = tables.all_tables(trace, program)
        t3 = time.perf_counter()
        elements = 0
        for cls in COMPONENT_CLASSES:
            comp = cls(meta.claim[cls.name])
            want = np.stack([host[comp.name][col] for col in comp.columns]).view(np.int32)
            got = mats[comp.name].cpu().numpy()
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"{name}: device table {comp.name} != host builder")
            elements += got.size
        out[name] = {"steps": len(trace), "max_log": max(meta.claim.values()),
                     "meta_s": t1 - t0, "device_build_s": t2 - t1, "host_build_s": t3 - t2,
                     "elements": elements, "bit_identical": True}
        del mats, host
        torch.cuda.empty_cache()
    _line("tables", out)
    return out


def phase_m31_path(m31: dict, per_mul: float, dispatch_per_s: float) -> dict:
    """The M31 path with its counts set to 0: the module's functions at
    2^24, then throughput_benchmark(24)."""
    K = m31_kernels
    K.KERNELS.launches = dict.fromkeys(K.KINDS, 0)
    K.PLAIN_CUDA_CALLS = 0
    a, b, c = m31["big"]
    for kind, got in (("mul", K.mul(a, b)), ("mul_add", K.mul_add(a, b, c)),
                      ("mul_chain", K.mul_chain(a, b, 8))):
        if not torch.equal(got, m31["wants"][kind]):
            raise AssertionError(f"M31 path: {kind} != its plain version")
    tb = K.throughput_benchmark(24)
    launches = dict(K.KERNELS.launches)
    expect = {"mul": 1, "mul_add": 1, "mul_chain": 1 + tb["kernel_launches"]}
    if launches != expect:
        raise AssertionError(f"M31 path launched {launches}, expected {expect}")
    if K.PLAIN_CUDA_CALLS != tb["plain_calls"]:
        raise AssertionError("M31 path: plain M31 ops ran beyond the benchmark's own")
    byte_rate = K.CHAIN * HBM_BYTES_PER_S / 12   # 8 products per 12 bytes moved
    dispatch_rate = dispatch_per_s / per_mul
    _line("m31_throughput", {
        "log_n": 24, "chain": K.CHAIN, "kernel_gmul_s": tb["kernel"] / 1e9,
        "plain_gmul_s": tb["plain"] / 1e9, "bound_gmul_s": min(byte_rate, dispatch_rate) / 1e9,
        "bound_by": "bytes" if byte_rate <= dispatch_rate else "operations",
        "bytes_bound_gmul_s": byte_rate / 1e9, "dispatch_bound_gmul_s": dispatch_rate / 1e9,
        "launches": launches, "plain_calls": K.PLAIN_CUDA_CALLS})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _smi("name,power.limit")
    max_mhz, sm_mhz = (float(v.split()[0]) for v in _smi("clocks.max.sm,clocks.sm").split(","))
    nvcc.build_all([circle_fft.KERNEL.lib, m31_kernels.KERNELS.lib])
    for lib in (circle_fft.KERNEL.lib, m31_kernels.KERNELS.lib):
        if lib.build_log.strip():
            print(lib.build_log.strip(), file=sys.stderr)
    sass = sass_per_mul()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dispatch_per_s = sms * 4 * 32 * max_mhz * 1e6  # SMs x schedulers x lanes x max SM clock
    _line("device", {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                     "sms": sms, "max_sm_mhz": max_mhz, "sm_mhz": sm_mhz,
                     "kernel_build_s": max(circle_fft.KERNEL.lib.build_seconds,
                                           m31_kernels.KERNELS.lib.build_seconds),
                     "sass": sass})

    kern = phase_kernel(sass, dispatch_per_s)
    m31 = phase_m31(sass["per_mul"], dispatch_per_s)
    # the dispatch bound counts 32 lanes a scheduler; beside it, the same
    # instructions at the integer issue rate that phase 3 reads
    for t in kern["times"].values():
        t["dispatch_at_issue_rate_ms"] = t["dispatch_bound_ms"] / m31["issue_share"]
    _line("kernel_times", kern["times"])
    # the M31 path: counts start at 0 inside
    m31_launches = phase_m31_path(m31, sass["per_mul"], dispatch_per_s)
    del m31["big"], m31["wants"]  # free the 2^24 operands before the prover runs
    torch.cuda.empty_cache()
    with open(os.path.join(ROOT, "programs", "fib19_io.bf")) as f:
        fib_code = f.read()
    with open(os.path.join(ROOT, "programs", "big22.bf")) as f:
        big_code = f.read()
    phase_tables([("small", SMALL_CODE, SMALL_INPUT.encode()),
                  ("fib19_io", fib_code, FIB_INPUT), ("big22", big_code, b"")])

    # the mesh prover: its transforms checked, then its path with the
    # counts at 0
    sharded_fft = phase_sharded_fft()
    _clear_prover_caches()
    _reset_counts()
    phase_small("sharded_small", ("--devices", "8"))
    for shards in (2, 4):
        phase_program("fib19_io", os.path.join(ROOT, "programs", "fib19_io.bf"), FIB_INPUT,
                      runs=2, expect_sha=REFERENCE_SHA256["fib19_io"], n_shards=shards)
    sharded_launches = circle_fft.KERNEL.launches
    if sharded_launches <= 0 or fft.PLAIN_CUDA_CALLS:
        raise AssertionError("the mesh prover did not run on the circle FFT kernel")
    _clear_prover_caches()

    # the prover's main path: counts start at 0 here
    _reset_counts()
    phase_small()
    phase_program("fib19_io", os.path.join(ROOT, "programs", "fib19_io.bf"), FIB_INPUT,
                  runs=3, expect_sha=REFERENCE_SHA256["fib19_io"])
    phase_program("big22", os.path.join(ROOT, "programs", "big22.bf"), b"",
                  runs=2, expect_sha=None)
    fft_launches = circle_fft.KERNEL.launches
    if fft_launches <= 0 or fft.PLAIN_CUDA_CALLS:
        raise AssertionError("main path did not run on the circle FFT kernel")

    headline = kern["times"]["evaluate (4, 2^24)"]
    kernels = [{
        "name": "circle_fft", "route": "cuda",
        "source": "stwo_brainfuck_tpu_torch/csrc/circle_fft.cu",
        "replaces": "stwo_brainfuck_tpu/ops/fft_pallas.py:364 (_make_pass1); "
                    "stwo_brainfuck_tpu/ops/fft_pallas.py:402 (_make_pass2)",
        "launches": fft_launches,
        "launches_by_path": {"prover": fft_launches, "sharded_prover": sharded_launches},
        "max_abs_err": max(kern["max_abs_err"], sharded_fft["max_abs_err"]),
        "ms": headline["kernel_ms"], "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"], "bound_by": headline["bound_by"],
        "library_ms": None,
    }]
    for kind, line in (("mul", 48), ("mul_add", 52), ("mul_chain", 111)):
        t = m31["times"][kind]
        kernels.append({
            "name": f"m31_{kind}", "route": "cuda",
            "source": "stwo_brainfuck_tpu_torch/csrc/m31_kernels.cu",
            "replaces": f"stwo_brainfuck_tpu/ops/m31_pallas.py:{line}",
            "launches": m31_launches[kind], "max_abs_err": m31["max_abs_err"][kind],
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    if not all(k["launches"] > 0 for k in kernels):
        raise AssertionError(f"a kernel was not launched on its path: {kernels}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
