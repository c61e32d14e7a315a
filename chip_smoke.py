"""Smoke run of the torch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device report: the card's name, power limit and clocks, CUDA version,
     kernel build time (the three kernel libraries are built with nvcc from
     stwo_brainfuck_tpu_torch/csrc/ into stwo_brainfuck_tpu_torch/build/,
     one nvcc per source, started together), and the SASS instruction
     counts of one M31 product, m31::mul, the FFT's m31::mul_doubled and
     one Blake2s compression (cuobjdump), which set the
     instruction-dispatch bounds;
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
     bit, for the small program, fib19_io and big22; then the Blake2s
     kernels against their plain versions on the card, bit for bit: the
     level kernel (BLAKE_COLS columns, with and without children,
     BLAKE_SIZES nodes, a length override, hash_words), the tail kernel
     from 2^TAIL_LOG nodes down, merkle.commit of every tree signature of a
     fib19_io and a small prove (against the plain commit on the card, and
     the small trees and fib19_io's FRI layer trees against the CPU, with
     the launches of each commit's plan), the grind against the host loop
     for pow_bits 8-20; then both versions timed at the main path's
     shapes beside their bounds;
  6. the mesh prover (stwo_brainfuck_tpu_torch/parallel/, D shards sharing
     the one card): the sharded evaluate, interpolate and extend (D 2, 4, 8;
     n 16, 20, 24; 1 and 8 columns) against the one-device kernel and the
     plain version, bit for bit, and one sharded evaluate (4, 2^24) at D = 4
     timed beside the one-device kernel's; then, counts set to 0 first, the
     small program through the CLI with --devices 8 (sha256, tamper) and
     fib19_io at D = 2 and 4 (sha256, verify), each with its per-phase
     split, peak device memory and FFT and Blake2s launches, no plain FFT
     or Blake2s on a CUDA tensor and no M31 kernel; the small program also
     at --pow-bits 16 with --devices 8 (the grind kernel);
  7. multi-process proving over torch.distributed
     (stwo_brainfuck_tpu_torch/parallel/multihost.py, one shard a process):
     the small program through `python -m stwo_brainfuck_tpu_torch.cli
     prove --distributed` as two processes sharing the card (gloo, at
     --pow-bits 16, so each runs the grind kernel), as one
     process with NCCL, and under torchrun with one NCCL process a card
     (sha256, verified on the card); fib19_io in two
     spawned processes sharing the card (gloo), cold then warm, each process
     reporting its phases, peak device memory, FFT launches and plain calls
     (counts at 0 before each prove); with two or more cards, fib19_io on
     two (and four) cards with NCCL. Every process must launch the FFT
     kernel and the Blake2s level and tail kernels and run no plain FFT or
     Blake2s on a CUDA tensor;
  8. the prover's main path, counts set to 0 first: the small program
     through the CLI entry point (prove, verify, proof sha256 against the
     JAX package's, a tampered copy rejected), again at --pow-bits 16 (the
     grind kernel; the proof equals the port's CPU proof), then fib19_io
     (programs/fib19_io.bf, input 19: 223,689 steps; prove once cold, twice
     warm, verify, sha256, the last proof verified by the CLI in a fresh
     process) and programs/big22.bf (1.32 M steps, 2^22-row tables; a
     fresh-process verify too), each with its per-phase split and peak
     device memory, then one more warm fib19_io prove under
     torch.profiler (device busy share, host syncs and the time waiting
     in them).
     After each prove the FFT kernel's and the Blake2s level and tail
     kernels' launch counts must have risen, no plain FFT or Blake2s may
     have run on a CUDA tensor and no M31 kernel or plain M31 op.
The last line of stdout is the JSON result; the line before it lists the
kernels, the one before that names the card. Needs no jax.

    python3 chip_smoke.py distributed

runs phase 7 alone, after one one-device fib19_io prove (cold and warm) to
hold it against: on a machine with several cards (one process a card,
NCCL) it is the multi-card check.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import io
import json
import logging
import multiprocessing
import os
import queue
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import struct
import traceback
from unittest import mock

import numpy as np
import torch

from stwo_brainfuck_tpu_torch import air, cli
from stwo_brainfuck_tpu_torch.components import device_build, tables
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES
from stwo_brainfuck_tpu_torch.core import blake2s, fft, merkle
from stwo_brainfuck_tpu_torch.core import fri, quotients
from stwo_brainfuck_tpu_torch.core.channel import _plain_grind
from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig
from stwo_brainfuck_tpu_torch.ops import blake2s_kernels, circle_fft, m31_kernels, nvcc
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
    # the small program at the CLI's --pow-bits 16 (the device grind's path)
    "small_pow16": "c8343b33e0d5cdf0c6ef2fd4662bdf782403d60fcf6bf154a494de2b1a3f3e45",
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
# a process group that has not finished by then failed (each of its
# processes is ended)
DIST_TIMEOUT_S = 300
# the Blake2s level kernel's checks: columns, nodes (the main path's widest
# FRI leaf level has 2^20 nodes, its deepest trees 2^21); the grind's
# pow_bits and digests
BLAKE_COLS = (0, 1, 4, 16, 17, 40)
BLAKE_SIZES = (1, 2, 3, 1 << 10, 1 << 20, 1 << 21)
POW_BITS = tuple(range(8, 21))
GRIND_DIGESTS = 3
M31_SIZES = (1, 127, 128, 4097, 1 << 20, 1 << 24)
M31_EDGES = (0, 1, 2**16 - 1, 2**16, 2**31 - 2)
P = 2**31 - 1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
MAX_SM_HZ = 1.98e9  # H100 SXM boost clock, for the length of a sleep kernel


def proof_sha256(proof: dict) -> str:
    return hashlib.sha256(json.dumps(proof, sort_keys=True).encode()).hexdigest()


def _line(tag: str, obj) -> None:
    print(f"{tag} {json.dumps(obj)}", flush=True)


def _time_ms(fn, reps: int = 5, queued: bool = False) -> float:
    """Mean device time of fn over `reps` runs, from CUDA events after one
    warm-up run. queued: the runs are first enqueued behind a 20 ms sleep
    kernel, so a kernel shorter than its host-side call is timed on the
    device alone (for fn that does not synchronize)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(int(0.02 * MAX_SM_HZ))
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


def sass_per_compress() -> dict:
    """SASS instructions of one Blake2s compression: csrc/blake2s.cu's two
    never-launched compress_probe instantiations differ by exactly one
    compression of the same block."""
    funcs = _sass_functions(blake2s_kernels.KERNELS.lib)
    one, two = (_sass_ops(funcs, f"compress_probeILi{k}E") for k in (1, 2))
    if len(two) <= len(one):
        raise AssertionError(f"SASS: compress probes {len(one)} and {len(two)} instructions")
    return {"per_compress": len(two) - len(one), "compress_probe1_instructions": len(one),
            "compress_probe2_instructions": len(two),
            "funnel_shifts": sum(o.startswith("SHF") for o in two) - sum(
                o.startswith("SHF") for o in one),
            "byte_perms": sum(o.startswith("PRMT") for o in two) - sum(
                o.startswith("PRMT") for o in one),
            "add3s": sum(o.startswith("IADD3") for o in two) - sum(
                o.startswith("IADD3") for o in one)}


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


# what each Blake2s entry point replaces: the JAX package's Blake2s
# compression (jnp, not Pallas) as XLA fuses it into one program a level, a
# chain of levels or a PoW batch
BLAKE_REPLACES = {
    "level": "stwo_brainfuck_tpu/core/blake2s.py:54 (_compress_t) fused by "
             "stwo_brainfuck_tpu/core/merkle.py:48 (_leaf_hash_jit) and :60 (_node_hash_jit)",
    "tail": "stwo_brainfuck_tpu/core/blake2s.py:54 (_compress_t) fused by "
            "stwo_brainfuck_tpu/core/merkle.py:68 (_chain_hash_jit)",
    "grind": "stwo_brainfuck_tpu/core/blake2s.py:54 (_compress_t) fused by "
             "stwo_brainfuck_tpu/core/channel.py:137 (_pow_batch)",
}


def _words(rng, shape) -> torch.Tensor:
    """Random 32-bit words as int32 on the card."""
    return torch.as_tensor(rng.integers(-2**31, 2**31, shape).astype(np.int32), device="cuda")


def _recorded_signatures(code: str, inp: bytes) -> list:
    """The tree signatures [(level, n_cols), ...] of every merkle.commit of
    one prove of the program on the card."""
    sigs = []
    real = merkle.commit

    def commit(columns_by_log):
        sigs.append(tuple(sorted(((k, m.shape[0]) for k, m in columns_by_log.items()),
                                 reverse=True)))
        return real(columns_by_log)

    machine = create_test_machine(compile_program(code), inp)
    machine.execute()
    with mock.patch.object(merkle, "commit", commit):
        air.prove_brainfuck(machine, device="cuda")
    torch.cuda.synchronize()
    return list(dict.fromkeys(sigs))


def _host_grinds(digest: bytes) -> dict:
    """pow_bits -> the smallest valid nonce for every POW_BITS, by hashlib
    over the nonces in order (one pass: a nonce valid for b + 1 bits is
    valid for b)."""
    want = {}
    bits = POW_BITS[0]
    nonce = 0
    while bits <= POW_BITS[-1]:
        h = int.from_bytes(hashlib.blake2s(digest + struct.pack("<Q", nonce)).digest()[:4],
                           "little")
        while bits <= POW_BITS[-1] and h & ((1 << bits) - 1) == 0:
            want[bits] = nonce
            bits += 1
        nonce += 1
    return want


def _level_work(children: bool, cols: int, m: int) -> tuple:
    """(bytes, compressions) of one level: each child digest and column word
    read once, each node's digest written once."""
    words = (16 if children else 0) + cols
    return 4 * m * words + 32 * m, m * max(1, -(-words // 16))


def phase_blake2s(per_compress: float, dispatch_per_s: float, fib_code: str,
                  small_code: str) -> dict:
    """The Blake2s kernels against their plain versions on the card, bit for
    bit: the level kernel over BLAKE_COLS x children x BLAKE_SIZES, a
    length override and hash_words; the tail kernel from 2^TAIL_LOG nodes
    down; merkle.commit of every tree signature of a fib19_io and a small
    prove against the plain commit on the card (emulate_commit), the small
    program's trees and fib19_io's FRI layer trees also against the CPU;
    the grind against the host loop for POW_BITS on GRIND_DIGESTS digests.
    Then both versions timed at the main path's shapes beside their bounds.
    No kernel call makes a plain call."""
    K = blake2s_kernels
    rng = np.random.default_rng(4)
    max_err = dict.fromkeys(K.ENTRIES, 0)
    checks = dict.fromkeys(K.ENTRIES, 0)

    def same(entry, got, want, what):
        if got.shape != want.shape:
            raise AssertionError(f"Blake2s {entry}: shape {tuple(got.shape)} != "
                                 f"{tuple(want.shape)} at {what}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err[entry] = max(max_err[entry], err)
        checks[entry] += 1
        if err:
            raise AssertionError(f"Blake2s {entry} kernel != plain: {what}")

    def kernel(fn):
        calls = blake2s.PLAIN_CUDA_CALLS
        out = fn()
        if blake2s.PLAIN_CUDA_CALLS != calls:
            raise AssertionError("a Blake2s kernel call ran the plain version")
        return out

    for n in BLAKE_SIZES:
        kids_all, cols_all = _words(rng, (8, 2 * n)), _words(rng, (max(BLAKE_COLS), n))
        for c in BLAKE_COLS:
            for kids in (None, kids_all):
                if not c and kids is None:
                    continue
                mat = cols_all[:c] if c else None  # a row slice: the kernel takes its stride
                got = kernel(lambda: K.KERNELS.level(kids, mat))
                same("level", got, K.level_plain(kids, mat),
                     f"C={c} children={kids is not None} N={n}")
        if n == 1 << 20:
            got = kernel(lambda: K.KERNELS.level(None, cols_all[:10], 40))
            same("level", got, K.level_plain(None, cols_all[:10], 40), "n_bytes 40, N=2^20")
            got = kernel(lambda: blake2s.hash_words(cols_all[:10], 40))
            same("level", got, blake2s.hash_parts([cols_all[:10]], 40), "hash_words, N=2^20")
        del kids_all, cols_all
    T = K.TAIL_LOG
    for top, bottom in ((T, 0), (T, T // 2), (T // 2, 0), (0, 0)):
        kids = _words(rng, (8, 2 << top))
        got = kernel(lambda: K.KERNELS.tail(kids, top, bottom))
        want = K.tail_plain(kids, top, bottom)
        for k in range(top, bottom - 1, -1):
            same("tail", got[k], want[k], f"tail {top}..{bottom}, level {k}")

    # whole trees: the signatures of real proves
    trees = {"fib19_io": _recorded_signatures(fib_code, FIB_INPUT),
             "small": _recorded_signatures(small_code, SMALL_INPUT.encode())}
    cpu_checked = 0
    for name, sigs in trees.items():
        for sig in sigs:
            cols = {k: _words(rng, (c, 1 << k)) for k, c in sig}
            before = dict(K.KERNELS.launches)
            tree = kernel(lambda: merkle.commit(cols))
            plan = K.launch_plan(sig)
            for kind in ("level", "tail"):
                if K.KERNELS.launches[kind] - before[kind] != sum(s[0] == kind for s in plan):
                    raise AssertionError(f"commit {sig}: {kind} launches differ from its plan")
            root, layers = K.emulate_commit(cols)
            entry = {k: "level" for _, k, _ in plan}
            entry.update({k: "tail" for kind, top, bottom in plan if kind == "tail"
                          for k in range(bottom, top + 1)})
            for k, want in layers.items():
                same(entry[k], tree.layers[k], want, f"{name} tree {sig}, level {k}")
            if root != tree.root:
                raise AssertionError(f"{name} tree {sig}: root differs from the plain commit")
            if name == "small" or (len(sig) == 1 and sig[0][1] == 4):
                host = merkle.commit({k: m.cpu() for k, m in cols.items()})
                if host.root != tree.root or any(
                        not torch.equal(host.layers[k], tree.layers[k].cpu()) for k in host.layers):
                    raise AssertionError(f"{name} tree {sig}: the card's commit != the CPU's")
                cpu_checked += 1
            del cols, tree, layers
    torch.cuda.empty_cache()

    grind_checks = 0
    for _ in range(GRIND_DIGESTS):
        digest = rng.integers(0, 256, 32).astype(np.uint8).tobytes()
        for bits, want in _host_grinds(digest).items():
            got = kernel(lambda: K.KERNELS.grind(digest, bits, "cuda"))
            if got != want:
                raise AssertionError(f"grind pow_bits={bits}: kernel {got}, host loop {want}")
            grind_checks += 1
    checks["grind"] = grind_checks
    _line("blake2s_check", {
        "level_cols": BLAKE_COLS, "level_sizes": BLAKE_SIZES, "tail_log": T,
        "tree_signatures": {k: [list(s) for s in v] for k, v in trees.items()},
        "trees_against_cpu": cpu_checked, "pow_bits": POW_BITS, "grind_digests": GRIND_DIGESTS,
        "comparisons": checks, "tolerance": 0, "max_abs_err": max_err})

    # times at the main path's shapes
    widest = max(((k, c, k < sig[0][0]) for sig in trees["fib19_io"] for k, c in sig),
                 key=lambda t: (t[1], t[2]))
    times = {}

    def timed(key, entry, k_fn, p_fn, nbytes, compressions):
        """kernel_ms: device time (the calls queued behind a sleep; the
        grind reads 4 bytes a batch, so its time is whole calls); call_ms:
        whole calls back to back, the wrapper's host work included."""
        same(entry, k_fn() if entry != "grind" else torch.tensor(k_fn()),
             p_fn() if entry != "grind" else torch.tensor(p_fn()), f"timed {key}")
        call_ms = _time_ms(k_fn, reps=10)
        times[key] = {"entry": entry,
                      "kernel_ms": call_ms if entry == "grind" else _time_ms(k_fn, 10, queued=True),
                      "call_ms": call_ms, "plain_ms": _time_ms(p_fn, reps=2),
                      "compressions": compressions,
                      **bound(nbytes, compressions * per_compress, dispatch_per_s)}

    leaf = _words(rng, (4, 1 << 20))
    timed("level: FRI leaf (4, 2^20)", "level", lambda: K.KERNELS.level(None, leaf),
          lambda: K.level_plain(None, leaf), *_level_work(False, 4, 1 << 20))
    kids = _words(rng, (8, 1 << 21))
    timed("level: digest-only 2^21 -> 2^20", "level", lambda: K.KERNELS.level(kids, None),
          lambda: K.level_plain(kids, None), *_level_work(True, 0, 1 << 20))
    k, c, with_kids = widest
    wide = _words(rng, (c, 1 << k))
    wkids = _words(rng, (8, 2 << k)) if with_kids else None
    timed(f"level: fib19_io's widest ({c}, 2^{k}){' with children' if with_kids else ''}",
          "level", lambda: K.KERNELS.level(wkids, wide), lambda: K.level_plain(wkids, wide),
          *_level_work(with_kids, c, 1 << k))
    del wide, wkids
    tkids = _words(rng, (8, 2 << T))
    timed(f"tail: 2^{T} -> 1", "tail", lambda: K.KERNELS.tail(tkids, T, 0)[0],
          lambda: K.tail_plain(tkids, T, 0)[0], 32 * (2 << T) + 32 * ((2 << T) - 1),
          (2 << T) - 1)
    timed("tree: FRI layer of 2^20 leaves", "level", lambda: merkle.commit({20: leaf}).layers[0],
          lambda: K.emulate_commit({20: leaf})[1][0], 16 * (1 << 20) + 32 * ((2 << 20) - 1),
          (2 << 20) - 1)
    digest = rng.integers(0, 256, 32).astype(np.uint8).tobytes()
    nonce = K.KERNELS.grind(digest, 16, "cuda")
    batches = nonce // (1 << K.GRIND_BATCH_LOG) + 1
    timed(f"grind: pow_bits 16 (nonce {nonce}, {batches} batch)", "grind",
          lambda: K.KERNELS.grind(digest, 16, "cuda"), lambda: _plain_grind(digest, 16, "cuda"),
          batches * (32 + 4), batches << K.GRIND_BATCH_LOG)
    del leaf, kids, tkids
    torch.cuda.empty_cache()
    _line("blake2s_times", times)
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
    blake2s_kernels.KERNELS.launches = dict.fromkeys(blake2s_kernels.ENTRIES, 0)
    blake2s.PLAIN_CUDA_CALLS = 0
    m31_kernels.KERNELS.launches = dict.fromkeys(m31_kernels.KINDS, 0)
    m31_kernels.PLAIN_CUDA_CALLS = 0


def _counts() -> dict:
    """The prover's kernels' launch counts: the FFT and each Blake2s entry."""
    return {"fft": circle_fft.KERNEL.launches, **blake2s_kernels.KERNELS.launches}


def _add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in {**a, **b}}


def _require(launched: dict, plain_fft: int, plain_blake: int, what: str,
             grind: bool = False) -> dict:
    """A prove's launches: the FFT, the Blake2s level and tail kernels (and
    the grind where pow_bits > 13) launched, no plain FFT or Blake2s call on
    a CUDA tensor."""
    needed = ("fft", "level", "tail") + (("grind",) if grind else ())
    missing = [k for k in needed if launched.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{what}: not launched: {missing} ({launched})")
    if plain_fft:
        raise AssertionError(f"{what}: the plain FFT ran on a CUDA tensor")
    if plain_blake:
        raise AssertionError(f"{what}: the plain Blake2s ran on a CUDA tensor")
    return launched


def _check_launches(before: dict, what: str, grind: bool = False) -> dict:
    now = _counts()
    launched = _require({k: now[k] - before[k] for k in now}, fft.PLAIN_CUDA_CALLS,
                        blake2s.PLAIN_CUDA_CALLS, what, grind)
    if any(m31_kernels.KERNELS.launches.values()) or m31_kernels.PLAIN_CUDA_CALLS:
        raise AssertionError(f"{what}: an M31 kernel or plain M31 op ran on the prover path")
    return launched


def phase_small(tag: str = "small", flags: tuple = (), reference: str = "small") -> dict:
    """The small program through the CLI entry point (`flags`: more prove
    arguments, such as --devices or --pow-bits 16; its proof's sha256 is
    REFERENCE_SHA256[reference]). At pow_bits 16 the grind kernel must
    have run and the proof equals the port's own proof on the CPU."""
    before = _counts()
    pow16 = "--pow-bits" in flags
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "proof.json")
        out = io.TextIOWrapper(io.BytesIO())  # the program's '.' output
        with contextlib.redirect_stdout(out):
            rc = cli.main(["prove", "--code", SMALL_CODE, "--input", SMALL_INPUT,
                           "--output", path, "--device", "cuda", "--log", "warning", *flags])
        if rc != 0:
            raise AssertionError(f"CLI prove exited {rc}")
        launched = _check_launches(before, f"{tag} prove", grind=pow16)
        with open(path) as f:
            proof = json.load(f)
        sha = proof_sha256(proof)
        if sha != REFERENCE_SHA256[reference]:
            raise AssertionError(f"{tag} proof sha256 {sha} != JAX reference")
        if pow16:
            machine = create_test_machine(compile_program(SMALL_CODE), SMALL_INPUT.encode())
            machine.execute()
            config = PcsConfig(log_max_rows=0, pow_bits=16)
            if json.dumps(air.prove_brainfuck(machine, config, device="cpu")) != json.dumps(proof):
                raise AssertionError(f"{tag}: the card's proof != the port's proof on the CPU")
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
                "tamper_rejected": True, "fft_launches": launched["fft"],
                "blake2s_launches": {k: launched[k] for k in blake2s_kernels.ENTRIES},
                **({"matches_cpu_proof": True} if pow16 else {})})
    return launched


def phase_program(name, path, inp, runs: int, expect_sha: str | None,
                  n_shards: int = 0, fresh_verify: bool = False) -> dict:
    """Prove (`runs` times, the first cold) and verify one program; on a
    mesh of `n_shards` shards over the visible cards if n_shards > 0. With
    fresh_verify, the last proof is also verified by the CLI in a new
    process (`fresh_verify` line)."""
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
        before = _counts()
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
            "fft_launches": launched["fft"],
            "blake2s_launches": {k: launched[k] for k in blake2s_kernels.ENTRIES},
            "sha256": sha, "matches_jax": None if expect_sha is None else True,
        })
        if fresh_verify and run == runs - 1:
            phase_fresh_verify(name, proof)
        del proof
        torch.cuda.empty_cache()
    return launched


def phase_fresh_verify(name: str, proof: dict) -> dict:
    """`python -m stwo_brainfuck_tpu_torch.cli verify <proof> --device cuda`
    in a new process: its wall time (interpreter, imports, CUDA context and
    the ladder tree included) and the verify_brainfuck call alone, as the
    CLI logs it."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "proof.json")
        with open(path, "w") as f:
            json.dump(proof, f)
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "stwo_brainfuck_tpu_torch.cli", "verify", path,
                              "--device", "cuda"], cwd=ROOT, capture_output=True, text=True,
                             timeout=DIST_TIMEOUT_S, env=dict(os.environ, STWO_BF_LOG="info"))
        process_s = time.perf_counter() - t0
    found = re.search(r"Verification OK \(([0-9.]+) s\)", res.stderr)
    if res.returncode != 0 or not found:
        raise AssertionError(f"{name}: fresh-process verify exited {res.returncode}:\n"
                             f"{res.stderr[-3000:]}")
    out = {"program": name, "process_s": process_s, "verify_s": float(found.group(1))}
    _line("fresh_verify", out)
    return out


def phase_split(name: str, path: str, inp: bytes) -> dict:
    """One more warm prove of the program under torch.profiler (no phase
    timer, so only the prove's own synchronizations): the device-busy
    share (the union of kernel and copy intervals over the prove's wall
    time), the host synchronizations the prove makes and the time spent
    waiting in them, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with open(path) as f:
        machine = create_test_machine(compile_program(f.read()), inp)
    machine.execute()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        air.prove_brainfuck(machine, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans, syncs, wait_us, by_kernel = [], {}, 0.0, {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us()
        elif "Synchronize" in ev.name:
            syncs[ev.name] = syncs.get(ev.name, 0) + 1
            wait_us += ev.time_range.elapsed_us()
    busy_us, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    out = {"program": name, "run": "warm, profiled", "prove_s": wall_s,
           "device_busy_s": busy_us / 1e6 if spans else None,
           "device_busy_share": busy_us / 1e6 / wall_s if spans else "not measured",
           "device_events": len(spans), "host_syncs": sum(syncs.values()), "syncs_by_call": syncs,
           "sync_wait_s": wait_us / 1e6, "top_device_us": dict(top)}
    _line("phase_split", out)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_counts(rank: int, launches: dict, plain_fft: int, plain_blake: int,
                 grind: bool = False) -> dict:
    """A process's kernel launches and plain FFT and Blake2s calls on CUDA
    tensors over one prove: the FFT, level and tail kernels (and the grind
    where pow_bits > 13) launched, no plain call."""
    _require(launches, plain_fft, plain_blake, f"process {rank}", grind)
    return {"fft_launches": launches["fft"],
            "blake2s_launches": {k: launches[k] for k in blake2s_kernels.ENTRIES},
            "plain_fft_cuda_calls": plain_fft, "plain_blake2s_cuda_calls": plain_blake}


_CLI_COUNTS = re.compile(r"Circle FFT kernel launches: (\d+); plain FFT calls on CUDA "
                         r"tensors: (\d+)")
_CLI_HASHES = re.compile(r"Blake2s kernel launches: level (\d+), tail (\d+), grind (\d+); "
                         r"plain Blake2s calls on CUDA tensors: (\d+)")


def _distributed_cli(world: int, backend: str, torchrun: bool = False,
                     pow_bits: int | None = None) -> dict:
    """The small program through `python -m stwo_brainfuck_tpu_torch.cli
    prove --distributed --device cuda` (at --pow-bits `pow_bits` if given),
    `world` processes on this machine's cards (on one card they share it),
    started one by one with the STWO_BF_* variables or by torchrun: the
    coordinator alone writes the proof, its sha256 is the JAX package's and
    it verifies on the card. Returns the launches of all processes."""
    port = _free_port()
    env = dict(os.environ, STWO_BF_BACKEND=backend, STWO_BF_LOG="info")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        def prove(output):
            # the level comes from STWO_BF_LOG: torchrun's argument parser
            # may take --log for an abbreviation of its --log-dir
            return ["-m", "stwo_brainfuck_tpu_torch.cli", "prove", "--code", SMALL_CODE,
                    "--input", SMALL_INPUT, "--output", os.path.join(tmp, output),
                    "--device", "cuda", "--distributed",
                    *(["--pow-bits", str(pow_bits)] if pow_bits else [])]

        try:
            if torchrun:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                     str(world), "--master-port", str(port), *prove("proof.json")],
                    cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for rank in range(0 if torchrun else world):
                procs.append(subprocess.Popen(
                    [sys.executable, *prove(f"rank{rank}.json")], cwd=ROOT,
                    env=dict(env, STWO_BF_NUM_PROCESSES=str(world),
                             STWO_BF_COORDINATOR=f"127.0.0.1:{port}",
                             STWO_BF_PROCESS_ID=str(rank)),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            outs = [p.communicate(timeout=DIST_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, (_, err) in zip(procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"distributed CLI ({world} x {backend}) exited "
                                     f"{p.returncode}:\n{err[-4000:]}")
        # one log a process, or torchrun's, which carries every process's
        counts = [c for _, err in outs for c in _CLI_COUNTS.findall(err)]
        hashes = [h for _, err in outs for h in _CLI_HASHES.findall(err)]
        times = [float(t) for _, err in outs for t in re.findall(r"proof time: ([0-9.]+) s", err)]
        written = sum(err.count("Proof written") for _, err in outs)
        if len(counts) != world or len(hashes) != world or len(times) != world or written != 1:
            raise AssertionError(f"distributed CLI ({world} x {backend}): {len(counts)} counts, "
                                 f"{len(hashes)} hash counts, {len(times)} times and {written} "
                                 f"proofs written in the logs")
        ranks = [{"prove_s": t, **_rank_counts(
                     i, {"fft": int(c[0]), **dict(zip(blake2s_kernels.ENTRIES, map(int, h[:3])))},
                     int(c[1]), int(h[3]), grind=bool(pow_bits and pow_bits > 13))}
                 for i, (c, h, t) in enumerate(zip(counts, hashes, times))]
        files = sorted(os.listdir(tmp))
        if files != (["proof.json"] if torchrun else ["rank0.json"]):
            raise AssertionError(f"distributed CLI: wrote {files}, only the coordinator writes")
        with open(os.path.join(tmp, files[0])) as f:
            proof = json.load(f)
    sha = proof_sha256(proof)
    reference = "small_pow16" if pow_bits == 16 else "small"
    if sha != REFERENCE_SHA256[reference]:
        raise AssertionError(f"distributed small proof ({world} x {backend}) sha256 {sha} "
                             f"!= JAX reference")
    air.verify_brainfuck(proof, device="cuda")
    _line("distributed", {"program": "small", "via": "torchrun" if torchrun else "cli",
                          "world": world, "backend": backend, "pow_bits": pow_bits or 10,
                          "sha256": sha, "matches_jax": True, "verified": True,
                          "processes": ranks})
    total = {}
    for r in ranks:
        total = _add_counts(total, {"fft": r["fft_launches"], **r["blake2s_launches"]})
    return total


def _prove_rank(rank: int, world: int, port: int, backend: str, device: str, runs: int,
                results) -> None:
    """One process of a fib19_io process group (started with spawn): joins
    the group, proves `runs` times (the first cold) on the global mesh with
    the counts set to 0 before each prove, and puts one result a prove on
    `results` (an error's traceback instead if it fails)."""
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        from stwo_brainfuck_tpu_torch.parallel import multihost

        multihost.initialize(f"127.0.0.1:{port}", world, rank, backend, device)
        try:
            mesh = multihost.global_mesh()
            with open(os.path.join(ROOT, "programs", "fib19_io.bf")) as f:
                code = compile_program(f.read())
            for run in range(runs):
                machine = create_test_machine(code, FIB_INPUT)
                machine.execute()
                torch.cuda.reset_peak_memory_stats(mesh.home)
                _reset_counts()
                timer = air.PhaseTimer(mesh.home)
                t0 = time.perf_counter()
                proof = air.prove_brainfuck(machine, timer=timer, mesh=mesh)
                torch.cuda.synchronize(mesh.home)
                res = {"rank": rank, "run": run, "device": str(mesh.home),
                       "steps": len(machine.trace()), "prove_s": time.perf_counter() - t0,
                       "phases_s": timer.seconds,
                       "peak_device_bytes": torch.cuda.max_memory_allocated(mesh.home),
                       "launches": _counts(),
                       "plain_fft_cuda_calls": fft.PLAIN_CUDA_CALLS,
                       "plain_blake2s_cuda_calls": blake2s.PLAIN_CUDA_CALLS,
                       "m31_launches": sum(m31_kernels.KERNELS.launches.values()),
                       "plain_m31_cuda_calls": m31_kernels.PLAIN_CUDA_CALLS}
                if multihost.is_coordinator():
                    t1 = time.perf_counter()
                    air.verify_brainfuck(proof, device=mesh.home)
                    res.update(verify_s=time.perf_counter() - t1, sha256=proof_sha256(proof),
                               proof_bytes=len(json.dumps(proof)))
                del proof
                results.put(res)
        finally:
            multihost.shutdown()
    except BaseException:
        results.put({"rank": rank, "error": traceback.format_exc()})
        raise


def _distributed_group(world: int, backend: str, device: str, runs: int) -> int:
    """fib19_io proved `runs` times by `world` spawned processes; one
    `distributed` line per prove. Returns the launches of all processes and
    proves."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_prove_rank, args=(r, world, port, backend, device, runs, results))
             for r in range(world)]
    got = []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + DIST_TIMEOUT_S
        while len(got) < world * runs:
            try:
                res = results.get(timeout=5)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise AssertionError(f"fib19_io process group ({world} x {backend}): "
                                         f"exit codes {[p.exitcode for p in procs]}, "
                                         f"{len(got)} of {world * runs} results")
                continue
            if "error" in res:
                raise AssertionError(f"fib19_io process {res['rank']} ({world} x {backend}) "
                                     f"failed:\n{res['error']}")
            got.append(res)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"fib19_io process group exit codes {[p.exitcode for p in procs]}")
    launched = {}
    for run in range(runs):
        ranks = sorted((r for r in got if r["run"] == run), key=lambda r: r["rank"])
        for r in ranks:
            r.update(_rank_counts(r["rank"], r["launches"], r["plain_fft_cuda_calls"],
                                  r["plain_blake2s_cuda_calls"]))
            if r["m31_launches"] or r["plain_m31_cuda_calls"]:
                raise AssertionError(f"process {r['rank']}: an M31 kernel or plain M31 op ran")
            launched = _add_counts(launched, r["launches"])
        sha = ranks[0]["sha256"]
        if sha != REFERENCE_SHA256["fib19_io"]:
            raise AssertionError(f"distributed fib19_io proof sha256 {sha} != JAX reference")
        _line("distributed", {
            "program": "fib19_io", "world": world, "backend": backend,
            "run": "cold" if run == 0 else "warm", "steps": ranks[0]["steps"],
            "prove_s": max(r["prove_s"] for r in ranks), "verify_s": ranks[0]["verify_s"],
            "khz": ranks[0]["steps"] / max(r["prove_s"] for r in ranks) / 1e3,
            "proof_bytes": ranks[0]["proof_bytes"], "sha256": sha, "matches_jax": True,
            "processes": [{k: r[k] for k in ("rank", "device", "prove_s", "phases_s",
                                         "peak_device_bytes", "fft_launches",
                                         "blake2s_launches", "plain_fft_cuda_calls",
                                         "plain_blake2s_cuda_calls")} for r in ranks]})
    return launched


def phase_distributed() -> int:
    """Multi-process proving over torch.distributed (every process starts
    its counts at 0): the small program through the CLI as two processes
    sharing the card (gloo), as one NCCL process, and under torchrun with
    one NCCL process a card (as many as a power of two allows); fib19_io
    in two processes sharing the card (gloo, cold then warm) and, with two
    or more cards, one process a card with NCCL (on two cards, and on four
    where there are four). The two gloo processes prove the small program
    at pow_bits 16, so each runs the grind kernel. Returns the launches of
    every process."""
    cards = torch.cuda.device_count()
    launched = _distributed_cli(2, "gloo", pow_bits=16)
    launched = _add_counts(launched, _distributed_cli(1, "nccl"))
    launched = _add_counts(launched, _distributed_cli(1 << (cards.bit_length() - 1), "nccl",
                                                      torchrun=True))
    launched = _add_counts(launched, _distributed_group(2, "gloo", "cuda:0", runs=2))
    if cards < 2:
        _line("distributed", {"nccl_multi_card": "not run: 1 card"})
    for world in (2, 4):
        if cards >= world:
            launched = _add_counts(launched, _distributed_group(world, "nccl", "cuda", runs=2))
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


def main(argv) -> int:
    if argv not in ([], ["distributed"]):
        print(f"usage: {sys.argv[0]} [distributed]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _smi("name,power.limit")
    max_mhz, sm_mhz = (float(v.split()[0]) for v in _smi("clocks.max.sm,clocks.sm").split(","))
    libs = (circle_fft.KERNEL.lib, m31_kernels.KERNELS.lib, blake2s_kernels.KERNELS.lib)
    nvcc.build_all(libs)
    for lib in libs:
        if lib.build_log.strip():
            print(lib.build_log.strip(), file=sys.stderr)
    if argv == ["distributed"]:
        # phase 7 alone (on a machine with several cards, its NCCL groups
        # across them), after the one-device fib19_io prove it is held against
        _reset_counts()
        phase_program("fib19_io", os.path.join(ROOT, "programs", "fib19_io.bf"), FIB_INPUT,
                      runs=2, expect_sha=REFERENCE_SHA256["fib19_io"])
        _clear_prover_caches()
        launched = phase_distributed()
        _require(launched, 0, 0, "the multi-process path", grind=True)
        print(card)
        print(json.dumps({"distributed_launches": launched, "cards": torch.cuda.device_count()}))
        return 0
    sass = {**sass_per_mul(), **sass_per_compress()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dispatch_per_s = sms * 4 * 32 * max_mhz * 1e6  # SMs x schedulers x lanes x max SM clock
    _line("device", {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                     "sms": sms, "max_sm_mhz": max_mhz, "sm_mhz": sm_mhz,
                     "kernel_build_s": max(lib.build_seconds for lib in libs),
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
    blake = phase_blake2s(sass["per_compress"], dispatch_per_s, fib_code, SMALL_CODE)

    # the mesh prover: its transforms checked, then its path with the
    # counts at 0
    sharded_fft = phase_sharded_fft()
    _clear_prover_caches()
    _reset_counts()
    phase_small("sharded_small", ("--devices", "8"))
    phase_small("sharded_small_pow16", ("--devices", "8", "--pow-bits", "16"), "small_pow16")
    for shards in (2, 4):
        phase_program("fib19_io", os.path.join(ROOT, "programs", "fib19_io.bf"), FIB_INPUT,
                      runs=2, expect_sha=REFERENCE_SHA256["fib19_io"], n_shards=shards)
    sharded = _require(_counts(), fft.PLAIN_CUDA_CALLS, blake2s.PLAIN_CUDA_CALLS,
                       "the mesh prover", grind=True)
    _clear_prover_caches()

    # multi-process proving: each process counts from 0 (the kernels it
    # loads were built above, in stwo_brainfuck_tpu_torch/build/)
    distributed = _require(phase_distributed(), 0, 0, "the multi-process path", grind=True)

    # the prover's main path: counts start at 0 here
    _reset_counts()
    phase_small()
    phase_small("small_pow16", ("--pow-bits", "16"), "small_pow16")
    fib_path = os.path.join(ROOT, "programs", "fib19_io.bf")
    phase_program("fib19_io", fib_path, FIB_INPUT, runs=3,
                  expect_sha=REFERENCE_SHA256["fib19_io"], fresh_verify=True)
    phase_program("big22", os.path.join(ROOT, "programs", "big22.bf"), b"",
                  runs=2, expect_sha=None, fresh_verify=True)
    # last: a profiled prove (its fib19_io caches are still warm)
    phase_split("fib19_io", fib_path, FIB_INPUT)
    main_path = _require(_counts(), fft.PLAIN_CUDA_CALLS, blake2s.PLAIN_CUDA_CALLS,
                         "the main path", grind=True)
    fft_launches = main_path["fft"]

    headline = kern["times"]["evaluate (4, 2^24)"]
    kernels = [{
        "name": "circle_fft", "route": "cuda",
        "source": "stwo_brainfuck_tpu_torch/csrc/circle_fft.cu",
        "replaces": "stwo_brainfuck_tpu/ops/fft_pallas.py:364 (_make_pass1); "
                    "stwo_brainfuck_tpu/ops/fft_pallas.py:402 (_make_pass2)",
        "launches": fft_launches,
        "launches_by_path": {"prover": fft_launches, "sharded_prover": sharded["fft"],
                             "distributed_prover": distributed["fft"]},
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
    headlines = {"level": "level: FRI leaf (4, 2^20)",
                 "tail": f"tail: 2^{blake2s_kernels.TAIL_LOG} -> 1",
                 "grind": next(k for k in blake["times"] if k.startswith("grind"))}
    for entry in blake2s_kernels.ENTRIES:
        t = blake["times"][headlines[entry]]
        kernels.append({
            "name": f"blake2s_{entry}", "route": "cuda",
            "source": "stwo_brainfuck_tpu_torch/csrc/blake2s.cu",
            "replaces": BLAKE_REPLACES[entry], "shape": headlines[entry],
            "launches": main_path[entry],
            "launches_by_path": {"prover": main_path[entry], "sharded_prover": sharded[entry],
                                 "distributed_prover": distributed[entry]},
            "max_abs_err": blake["max_abs_err"][entry],
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
    sys.exit(main(sys.argv[1:]))
