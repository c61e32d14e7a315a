"""Smoke run of the torch port's main path on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device report: the card's name and power limit, CUDA version, kernel
     build time (the circle FFT kernel is built with nvcc from
     stwo_brainfuck_tpu_torch/csrc/ into stwo_brainfuck_tpu_torch/build/);
  2. the kernel against its plain torch version on the card, bit for bit,
     for evaluate / interpolate / extend, and both versions' times;
  3. the small program through the CLI entry point: prove, verify, proof
     sha256 against the JAX package's, a tampered copy rejected;
  4. a fib19-class program (programs/fib19_io.bf, input 19: 223,689 steps):
     prove (once cold, twice warm) and verify, proof sha256 against the JAX
     package's, per-phase split and peak device memory;
  5. programs/big22.bf (1.32 M steps, 2^22-row tables): the same figures.
After each prove the FFT kernel's launch count must have risen and the
plain FFT must not have run on a CUDA tensor. The last line of stdout is
the JSON result; the line before it lists the kernels. Needs no jax.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import io
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from stwo_brainfuck_tpu_torch import air, cli
from stwo_brainfuck_tpu_torch.core import fft
from stwo_brainfuck_tpu_torch.ops import circle_fft
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

FFT_SIZES = (4, 11, 16, 17, 20, 24)


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


def phase_kernel() -> dict:
    """The kernel vs its plain version on the same CUDA tensors."""
    rng = np.random.default_rng(0)
    p = 2**31 - 1
    max_err = 0
    checked = 0
    for n in FFT_SIZES:
        for cols in (1, 8):
            x = torch.as_tensor(rng.integers(0, p, (cols, 1 << n)).astype(np.int32),
                                device="cuda")
            pairs = [
                (circle_fft.evaluate(x, n), fft.evaluate_plain(x, n)),
                (circle_fft.interpolate(x, n), fft.interpolate_plain(x, n)),
            ]
            if n < 24:
                c, e = fft.extend_with_coeffs(x, n, 1)
                cp = fft.interpolate_plain(x, n)
                pad = torch.zeros((cols, 1 << (n + 1)), dtype=torch.int32, device="cuda")
                pad[:, : 1 << n] = cp
                pairs += [(c, cp), (e, fft.evaluate_plain(pad, n + 1))]
            torch.cuda.synchronize()
            for got, want in pairs:
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                max_err = max(max_err, err)
                if err:
                    raise AssertionError(f"circle FFT kernel != plain at n={n} C={cols}")
                checked += 1
    _line("kernel_check", {"sizes": FFT_SIZES, "cols": [1, 8], "comparisons": checked,
                           "tolerance": 0, "max_abs_err": max_err})

    times = {}
    shapes = [("evaluate", 4, 24), ("interpolate", 4, 23), ("extend", 8, 19),
              ("extend", 40, 22)]
    for op, cols, n in shapes:
        x = torch.as_tensor(rng.integers(0, p, (cols, 1 << n)).astype(np.int32), device="cuda")
        if op == "evaluate":
            k, pl = (lambda: circle_fft.evaluate(x, n)), (lambda: fft.evaluate_plain(x, n))
        elif op == "interpolate":
            k, pl = (lambda: circle_fft.interpolate(x, n)), (lambda: fft.interpolate_plain(x, n))
        else:
            def pl():
                cp = fft.interpolate_plain(x, n)
                pad = torch.zeros((cols, 1 << (n + 1)), dtype=torch.int32, device="cuda")
                pad[:, : 1 << n] = cp
                return fft.evaluate_plain(pad, n + 1)

            k = lambda: fft.extend_with_coeffs(x, n, 1)  # noqa: E731
        key = f"{op} ({cols}, 2^{n})"
        times[key] = {"kernel_ms": _time_ms(k), "plain_ms": _time_ms(pl, reps=2)}
        del x
        torch.cuda.empty_cache()
    _line("kernel_times", times)
    return {"max_abs_err": max_err, "times": times}


def _check_launches(before: int, what: str) -> int:
    launched = circle_fft.KERNEL.launches - before
    if launched <= 0:
        raise AssertionError(f"{what}: the circle FFT kernel was not launched")
    if fft.PLAIN_CUDA_CALLS:
        raise AssertionError(f"{what}: the plain FFT ran on a CUDA tensor")
    return launched


def phase_small() -> int:
    """The small program through the CLI entry point."""
    before = circle_fft.KERNEL.launches
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "proof.json")
        out = io.TextIOWrapper(io.BytesIO())  # the program's '.' output
        with contextlib.redirect_stdout(out):
            rc = cli.main(["prove", "--code", SMALL_CODE, "--input", SMALL_INPUT,
                           "--output", path, "--device", "cuda", "--log", "warning"])
        if rc != 0:
            raise AssertionError(f"CLI prove exited {rc}")
        launched = _check_launches(before, "small prove")
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
    _line("small", {"sha256": sha, "matches_jax": True, "tamper_rejected": True,
                    "fft_launches": launched})
    return launched


def phase_program(name, path, inp, runs: int, expect_sha: str | None) -> int:
    """Prove (`runs` times, the first cold) and verify one program."""
    with open(path) as f:
        code = compile_program(f.read())
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
        proof = air.prove_brainfuck(machine, device="cuda", timer=timer)
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
        _line(name, {
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    circle_fft.KERNEL.library()
    _line("device", {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                     "kernel_build_s": circle_fft.KERNEL.build_seconds})
    if circle_fft.KERNEL.build_log.strip():
        print(circle_fft.KERNEL.build_log.strip(), file=sys.stderr)

    kern = phase_kernel()

    # the main path's run: counts start at 0 here
    circle_fft.KERNEL.launches = 0
    fft.PLAIN_CUDA_CALLS = 0
    phase_small()
    phase_program("fib19_io", os.path.join(ROOT, "programs", "fib19_io.bf"), FIB_INPUT,
                  runs=3, expect_sha=REFERENCE_SHA256["fib19_io"])
    phase_program("big22", os.path.join(ROOT, "programs", "big22.bf"), b"",
                  runs=2, expect_sha=None)
    launches = circle_fft.KERNEL.launches
    if launches <= 0 or fft.PLAIN_CUDA_CALLS:
        raise AssertionError("main path did not run on the circle FFT kernel")

    headline = kern["times"]["evaluate (4, 2^24)"]
    print(card)
    print(json.dumps({"kernels": [{
        "name": "circle_fft", "route": "cuda",
        "source": "stwo_brainfuck_tpu_torch/csrc/circle_fft.cu",
        "replaces": "stwo_brainfuck_tpu/ops/fft_pallas.py:364",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": headline["kernel_ms"], "plain_ms": headline["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
