"""Smoke run of the torch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device report: the card's name, power limit and clocks, CUDA version,
     kernel build time (the kernel libraries are built with nvcc from
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
  5. the table build on the card (components/device_build.build_tables:
     the meta pass on the device, one pull, one launch of
     csrc/tables.cu) for the small program, fib19_io and big22: the meta
     pass against the host pass build_meta field by field, the kernel's 13
     matrices against its plain version and the host builders, bit for
     bit; the meta pass, its pull, the kernel (beside its bytes bound),
     the plain build and build_meta timed; then the Blake2s
     kernels against their plain versions on the card, bit for bit: the
     level kernel (BLAKE_COLS columns, with and without children,
     BLAKE_SIZES nodes, a length override, hash_words), the tree kernel
     (one launch a tree, every level against tree_plain) over TREE_CASES,
     row-sliced columns and given children, merkle.commit of every tree
     signature of a fib19_io and a small prove (the small trees and
     fib19_io's FRI layer trees also against the CPU), the largest fib19_io
     tree committed TREE_REPEATS times back to back, two trees back to
     back and a commit over 4 shards of the card; the grind against the
     host loop for pow_bits 8-20; then the compression probe (the card's
     rate, one warp's latency) and both versions timed at the main path's
     shapes (the 2^20-leaf FRI layer tree and every fib19_io tree as whole
     commits) beside the dispatch bound, the bound at the measured rate
     and a tree's root-chain latency floor; the grind's whole calls at
     pow_bits 16 (the small_pow16 proof's digest and GRIND_TIMED more)
     beside the work the search needs at the measured rate plus one
     launch and read; then the quotient kernel against its plain version
     on the card, bit for bit, at every quotient shape of a fib19_io prove
     at the default config and at production parameters (up to (4, 2^28),
     the plain version in 2^24-position ranges), the default shapes and
     the 2^28 one timed beside the bounds, each launch's schedule against
     the wrapper's mirror; then the constraint kernels (csrc/constraints.cu:
     composition, one launch a prove, against the plain Expr path summed a
     size, interaction, the whole LogUp
     interaction trace, against framework.interaction_plain, and on its
     inputs the mesh's pair: logup against the plain fractions and the
     LogUp scan, csrc/logup_scan.cu, against the plain prefix sum), bit for
     bit, for every component at every shape of a default fib19_io, a big22
     and a production fib19_io prove: on the proves' own inputs (each shape
     and each prove's composition launch timed beside its bounds and the
     plain version's time; the interaction
     beside the logup + scan pair; the scan as the mesh runs it, the second
     of 2 and of 4 linear chunks with its carry, and in coset mode, which
     no prove path runs, each beside torch.cumsum of the same rows), on
     random and on edge inputs (zero denominators among them; the scan
     also of edge-valued row sums, in both modes), and in 4 chunks against
     one launch (the scan: 4 linear chunks chained by their carries); then
     the OODS kernel (csrc/oods.cu) and the FRI fold kernel
     (csrc/fri_fold.cu) against their plain versions, bit for bit, at every
     launch of a default fib19_io, a big22 and a production fib19_io prove
     (the 2^28-position circle fold among them), each also as a mesh
     shard's chunks at their offsets, each timed beside its bound and its
     plain version (the `oods_fri` line);
  6. the mesh prover (stwo_brainfuck_tpu_torch/parallel/, D shards sharing
     the one card): the sharded evaluate, interpolate and extend (D 2, 4, 8;
     n 16, 20, 24; 1 and 8 columns) against the one-device kernel and the
     plain version, bit for bit, and one sharded evaluate (4, 2^24) at D = 4
     timed beside the one-device kernel's; the mesh-stage kernel
     (csrc/mesh_stages.cu: every cross stage and the in-place sum) against
     its plain version at the main path's 2^28-position chunk, bit for bit,
     in place and into another buffer, and timed beside its byte bound and
     the plain version (the `mesh_stages` line); then, counts set to 0
     first, the small program through the CLI with --devices 8 (sha256,
     tamper) and fib19_io at D = 2 and 4 (sha256, verify), each with its
     per-phase split (the decommitment in one device->host pull), peak
     device memory and FFT, Blake2s and quotient launches, the mesh-stage
     kernel once a shard a cross-stage chunk (the recording's `fft.cross`
     spans) and once a sum, no plain FFT, Blake2s, quotient or mesh-stage
     call on a CUDA tensor and no M31 kernel; the small program also at
     --pow-bits 16 with --devices 8 (the grind kernel);
  7. multi-process proving over torch.distributed
     (stwo_brainfuck_tpu_torch/parallel/multihost.py, one shard a process):
     the small program through `python -m stwo_brainfuck_tpu_torch.cli
     prove --distributed` as two processes sharing the card (gloo, at
     --pow-bits 16, so each runs the grind kernel), as one
     process with NCCL, and under torchrun with one NCCL process a card
     (sha256, verified on the card); fib19_io in two
     spawned processes sharing the card (gloo), cold then warm, each process
     reporting its phases (the decommitment in one pull and one
     all_reduce), peak device memory, FFT launches, mesh-stage launches
     (one a cross-stage chunk and one a sum) and plain calls
     (counts at 0 before each prove); with two or more cards, fib19_io on
     two (and four) cards with NCCL. Every process must launch the FFT
     kernel and the Blake2s tree kernel (at most twice a commit: its shard's
     subtree and the top) and run no plain FFT or Blake2s on a CUDA tensor;
  8. the prover's main path, counts set to 0 first: the small program
     through the CLI entry point (prove, verify, proof sha256 against the
     JAX package's, a tampered copy rejected), again at --pow-bits 16 (the
     grind kernel; the proof equals the port's CPU proof), then fib19_io
     (programs/fib19_io.bf, input 19: 223,689 steps; prove once cold, twice
     warm, verify, sha256, the last proof verified by the CLI in a fresh
     process) and programs/big22.bf (1.32 M steps, 2^22-row tables; a
     fresh-process verify too), each with its per-phase split and peak
     device memory (every prove's decommitment in one device->host pull),
     then one more warm fib19_io prove under torch.profiler (device busy
     share, host syncs and the time waiting in them, garbage-collection
     pauses, and the decommit phase's seconds, pulls, device-to-host
     copies and host syncs).
     After each prove the FFT kernel's, the Blake2s tree kernel's, the
     quotient kernel's, the constraint kernels', the OODS kernel's and the
     fold kernel's launch counts must have risen (on one device one OODS
     launch, its samples pulled once, and one fold launch a committed FRI
     layer plus the last fold) (the tree kernel once a commit on one device, at most once a
     shard and once for the top on the mesh; the composition kernel once a
     prove and the interaction kernel once a component on one device and no
     logup or scan launch, the composition kernel once a device of the
     mesh's shards; on a mesh the logup kernel and the scan once a shard above
     the sharded sizes; the table kernel once a prove, on every path, its
     counts pulled once), no plain FFT, Blake2s, quotient, constraint-path
     (the prefix sum included), OODS, fold or table call may have run on a
     CUDA tensor, no host table pass (build_meta), no M31 kernel or
     plain M31 op, and no mesh-stage launch or plain mesh stage; the
     profiled prove's tables phase makes one host sync and one
     device-to-host copy;
  9. production parameters (PcsConfig(log_blowup=4, n_queries=30,
     pow_bits=16)): the memory reading (production_memory: one cold
     fib19_io prove at input 19 under the allocator's history, its peak,
     the phase at the peak and the largest blocks live then with their
     allocation stacks); then, counts at 0 first: the fused extend against its plain
     version, bit for bit, at every extend shape of a production fib19_io
     prove (input 19; up to (4, 2^24) -> 2^28); the small program's proof
     against the JAX package's sha256 (small_production), verified;
     fib19_io at its 2^18-table input (16) and at input 19 (the
     composition committed at 2^28 leaves) proved cold and warm, one
     sha256 an input, verified, with peak device memory, the grind kernel
     once a prove, the tree kernel once a commit;
  10. the bench: `python -m stwo_brainfuck_tpu_torch.bench` in a process
     (BENCH_BIG=0), sent SIGTERM after its headline and small rows: one
     final line (printed here as the `bench` line) with the fib19_io
     headline's JAX sha256, verified, and every suite row listed.
The last line of stdout is the JSON result; the line before it lists the
kernels (each with its launches on its own path: the logup kernel and the
scan on the mesh prover's, the others on the main path's), the one before
that names the card. Needs no jax.

    python3 chip_smoke.py distributed

runs phase 7 alone, after one one-device fib19_io prove (cold and warm) to
hold it against: on a machine with several cards (one process a card,
NCCL) it is the multi-card check.

    python3 chip_smoke.py mesh

runs phase 6's mesh-stage check alone, then fib19_io on four shards of the
card (cold and warm) and in two processes sharing it (gloo), each prove's
mesh-stage launches held against its cross-stage chunks and sums.

    python3 chip_smoke.py production_memory

runs the memory reading of phase 9 alone (and exits non-zero if that
prove runs out of memory).
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
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
import signal
import tempfile
import threading
import time
import struct
import traceback
from unittest import mock

import numpy as np
import torch

from stwo_brainfuck_tpu_torch import air, bench, cli, tracing
from stwo_brainfuck_tpu_torch.components import device_build, tables
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES, ELEMENT_SIZES
from stwo_brainfuck_tpu_torch.core import blake2s, fft, fri, merkle, poly, quotients
from stwo_brainfuck_tpu_torch.core.channel import _plain_grind
from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig
from stwo_brainfuck_tpu_torch.framework import component as framework
from stwo_brainfuck_tpu_torch.ops import (blake2s_kernels, circle_fft, constraint_kernels,
                                           fri_kernels, m31_kernels, mesh_kernels, nvcc,
                                           oods_kernels, quotient_kernels, table_kernels)
from stwo_brainfuck_tpu_torch.parallel import fft_sharded
from stwo_brainfuck_tpu_torch.parallel.merkle_sharded import commit_sharded
from stwo_brainfuck_tpu_torch.parallel.mesh import make_mesh
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine

ROOT = os.path.dirname(os.path.abspath(__file__))

# sha256 of json.dumps(proof, sort_keys=True) of the JAX package's proofs
# (stwo_brainfuck_tpu.air.prove_brainfuck with JAX on the CPU): "small" and
# "fib19_io" at the default config, "small_pow16" at pow_bits 16 and
# "small_production" at PcsConfig(log_blowup=4, n_queries=30, pow_bits=16,
# log_max_rows=0); kept with the bench, which checks them too
REFERENCE_SHA256 = bench.REFERENCE_SHA256
# proofs the port made on an H100 before the constraint kernels (no JAX
# sha256 exists for them: the JAX package cannot prove them on one TPU chip)
RECORDED_SHA256 = {
    "big22": "5c139331130d76c6b27135106e697e524db5b5d467c2ce7df4b4021abf1954f3",
    "fib19_io_in19_production":
        "f4a24c9b217338bb49ceaf8f84541c1b1ba5efd9402e826deddb8428c939874d",
}
proof_sha256 = bench.proof_sha256
PRODUCTION = bench.CONFIGS["production"]
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
# the tree kernel's synthetic trees {level: n_cols}, beside the recorded
# signatures of real proves (a CTA owns 2^8 nodes of its stage's top; on an
# H100 a tree of 2^21 leaves runs stages from levels 21, 17, 13, 9 and 5)
TREE_CASES = {
    "1 node": {0: 5},
    "2 nodes": {1: 3},
    "2^8 nodes, one CTA": {8: 4},
    "2^9 nodes, two stages": {9: 4},
    "columns at the top, middle and bottom of a run": {20: 3, 13: 20, 0: 2},
    "a column at every level, four stages": {k: 1 for k in range(18, -1, -1)},
    "columns at each stage's top": {21: 2, 17: 17, 13: 1, 9: 3, 5: 1},
    "column blocks of 57, 16, 17 and 33 words": {12: 57, 11: 16, 10: 17, 9: 33},
}
# the largest fib19_io tree is committed this many times back to back (the
# cross-CTA reads of the tree kernel)
TREE_REPEATS = 50
# the compression-rate probe: chain length on a full card, and on one warp
# (the latency of one dependent compression)
PROBE_CHAIN = 64
PROBE_WARP_CHAIN = 256
# the main path's widest FRI layer tree has 2^FRI_LOG leaves (4 columns)
FRI_LOG = 20
POW_BITS = tuple(range(8, 21))
GRIND_DIGESTS = 3
GRIND_TIMED = 4  # random digests timed at pow_bits 16, beside the small_pow16 proof's
M31_SIZES = (1, 127, 128, 4097, 1 << 20, 1 << 24)
M31_EDGES = (0, 1, 2**16 - 1, 2**16, 2**31 - 2)
P = 2**31 - 1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
TABLE_REPS = 3  # warm runs of the table build a program (phase_tables)
MAX_SM_HZ = 1.98e9  # H100 SXM boost clock, for the length of a sleep kernel
# the production memory reading: the largest live blocks listed at the
# peak, and the allocator events recorded
MEMORY_TOP = 10
MEMORY_EVENTS = 500_000
# the quotient kernel's checks: the plain version runs over ranges of
# 2^QUOTIENT_CHUNK_LOG positions; production shapes from 2^QUOTIENT_TIMED_LOG
# positions are timed; a group's M31 products at a point besides its
# members' and its batch's M31 inversion (B * py 4, the vanishing line 8,
# den's two CM31 squares 4, the norm 2, num (A - Bu) 16, times conj(den) 8,
# the batched inversion's 3, times the inverse 4: csrc/quotients.cu), and
# the products of one M31 inversion (a batch of K points shares one)
QUOTIENT_CHUNK_LOG = 24
QUOTIENT_TIMED_LOG = 28
QUOTIENT_GROUP_PRODUCTS = 49
M31_INV_PRODUCTS = 42
# the constraint kernels' checks: the plain version over ranges of
# 2^CONSTRAINT_CHUNK_LOG rows; on random and edge inputs the first and last
# 2^CONSTRAINT_SAMPLE_LOG rows of a shape; the chunked check's chunk count
CONSTRAINT_CHUNK_LOG = 22
CONSTRAINT_SAMPLE_LOG = 20
CONSTRAINT_CHUNKS = 4
MESH_SHARDS = (2, 4)  # the one-process mesh's shard counts on fib19_io
# The mesh-stage kernel's checked and timed shape: one column of a 2^30
# transform's shard over four cards, the largest chunk the main path gives it
MESH_STAGE_LOG = 28
SCAN_REPLACES = ("stwo_brainfuck_tpu/framework/component.py:674 (_qm31_cumsum, the prefix "
                 "half of :372 _build_interaction_fn)")


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


def phase_mesh_stages() -> dict:
    """The mesh-stage kernel (csrc/mesh_stages.cu) against its plain
    version on the same CUDA tensors, bit for bit, at the main path's chunk
    shape (2^MESH_STAGE_LOG positions, the first pairs every pairing of 0,
    1, p - 2 and p - 1): each stage the sharded transforms and the
    composition's sum make (the evaluate's lower and upper cross stage, the
    interpolate's, unscaled and with the 2^-n of the last stage folded in,
    add_into) in place on the shard's buffer, and the cross stages also into
    another buffer; each stage timed in place beside its byte bound (12 B a
    position: the shard's word read and written, the partner's read) and
    the plain version, with the launches and plain calls counted."""
    p = mesh_kernels.P
    n = 1 << MESH_STAGE_LOG
    gen = torch.Generator(device="cuda").manual_seed(MESH_STAGE_LOG)
    x = torch.randint(0, p, (n,), dtype=torch.int32, device="cuda", generator=gen)
    y = torch.randint(0, p, (n,), dtype=torch.int32, device="cuda", generator=gen)
    edges = torch.tensor([0, 1, p - 2, p - 1], dtype=torch.int32, device="cuda")
    x[:16], y[:16] = edges.repeat_interleave(4), edges.repeat(4)
    t, s = 1234567891 % p, fft.inv_pow2(MESH_STAGE_LOG + 2)
    K = mesh_kernels
    stages = {  # name: (kernel call (own, partner, out), plain op, its constant)
        "evaluate_lower": (lambda a, b, o: K.evaluate_cross(a, b, t, False, out=o),
                           K.EVAL_LOWER, t),
        "evaluate_upper": (lambda a, b, o: K.evaluate_cross(a, b, t, True, out=o),
                           K.EVAL_UPPER, t),
        "interpolate_lower": (lambda a, b, o: K.interpolate_cross(a, b, t, False, out=o),
                              K.ADD, 1),
        "interpolate_lower_scaled": (
            lambda a, b, o: K.interpolate_cross(a, b, t, False, scale=s, out=o),
            K.ADD_SCALED, s),
        "interpolate_upper": (lambda a, b, o: K.interpolate_cross(a, b, t, True, out=o),
                              K.SUB_MUL, t),
        "interpolate_upper_scaled": (
            lambda a, b, o: K.interpolate_cross(a, b, t, True, scale=s, out=o),
            K.SUB_MUL, t * s % p),
        "add_into": (lambda a, b, o: K.add_into(a, b), K.ADD, 1),
    }
    reps = 10
    launches0, guard = K.KERNEL.launches, K.PLAIN_CUDA_CALLS
    launched = plain_calls = checked = 0
    bound_ms = 12 * n / HBM_BYTES_PER_S * 1e3
    times = {}
    for name, (call, op, c) in stages.items():
        want = K.stage_plain(op, x, y, c, torch.empty_like(x))
        plain_calls += 1
        got = x.clone()
        call(got, y, got)
        launched += 1
        outs = [got]
        if name != "add_into":
            into = torch.full_like(x, -1)
            call(x, y, into)
            launched += 1
            outs.append(into)
        for o in outs:
            if not torch.equal(o, want):
                raise AssertionError(f"mesh stage {name} at 2^{MESH_STAGE_LOG} != plain")
            checked += 1
        del want, got, outs
        work = x.clone()
        kernel_ms = _time_ms(lambda: call(work, y, work), reps=reps)
        plain_ms = _time_ms(lambda: K.stage_plain(op, work, y, c, work), reps=reps)
        launched += reps + 1
        plain_calls += reps + 1
        times[name] = {"kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "share_of_bound": bound_ms / kernel_ms}
        del work
    torch.cuda.synchronize()
    if K.KERNEL.launches - launches0 != launched:
        raise AssertionError(f"mesh stages: {K.KERNEL.launches - launches0} launches, not "
                             f"{launched}")
    if K.PLAIN_CUDA_CALLS - guard != plain_calls:
        raise AssertionError("a plain mesh stage ran on a CUDA tensor outside the named calls")
    del x, y
    torch.cuda.empty_cache()
    _line("mesh_stages", {"positions": n, "comparisons": checked, "tolerance": 0,
                          "max_abs_err": 0, "launches": launched, "plain_calls": plain_calls,
                          "times": times})
    return {"max_abs_err": 0, "times": times}


# what each Blake2s entry point replaces: the JAX package's Blake2s
# compression (jnp, not Pallas) as XLA fuses it into one program a level, a
# chain of levels or a PoW batch
BLAKE_REPLACES = {
    "tree": "stwo_brainfuck_tpu/core/blake2s.py:54 (_compress_t) fused by "
            "stwo_brainfuck_tpu/core/merkle.py:48 (_leaf_hash_jit), :60 (_node_hash_jit) "
            "and :68 (_chain_hash_jit) on the schedule of :78 (level_plan)",
    "level": "stwo_brainfuck_tpu/core/blake2s.py:54 (_compress_t) fused by "
             "stwo_brainfuck_tpu/core/blake2s.py:123 (_hash_words_jit)",
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


def _host_grinds(digest: bytes, pow_bits=POW_BITS) -> dict:
    """pow_bits -> the smallest valid nonce for each of the consecutive
    pow_bits, by hashlib over the nonces in order (one pass: a nonce valid
    for b + 1 bits is valid for b)."""
    want = {}
    bits = pow_bits[0]
    nonce = 0
    while bits <= pow_bits[-1]:
        h = int.from_bytes(hashlib.blake2s(digest + struct.pack("<Q", nonce)).digest()[:4],
                           "little")
        while bits <= pow_bits[-1] and h & ((1 << bits) - 1) == 0:
            want[bits] = nonce
            bits += 1
        nonce += 1
    return want


def _small_pow16_digest(small_code: str) -> bytes:
    """The transcript digest the small program's prove at pow_bits 16 grinds
    on (the small_pow16 proof's PoW), from a prove on the card."""
    seen = []
    real = blake2s_kernels.KERNELS.grind
    machine = create_test_machine(compile_program(small_code), SMALL_INPUT.encode())
    machine.execute()
    with mock.patch.object(blake2s_kernels.KERNELS, "grind",
                           lambda digest, bits, device: seen.append(digest) or real(
                               digest, bits, device)):
        air.prove_brainfuck(machine, PcsConfig(log_max_rows=0, pow_bits=16), device="cuda")
    if len(seen) != 1:
        raise AssertionError(f"the small prove at pow_bits 16 ground {len(seen)} times")
    return seen[0]


def _level_work(children: bool, cols: int, m: int) -> tuple:
    """(bytes, compressions) of one level: each child digest and column word
    read once, each node's digest written once."""
    words = (16 if children else 0) + cols
    return 4 * m * words + 32 * m, m * max(1, -(-words // 16))


def _tree_work(sig) -> tuple:
    """(bytes, compressions, root chain) of a whole tree of signature sig
    [(level, n_cols), ...]: each column word read once and each digest
    written once; a node's compressions are its message's 16-word blocks;
    the root chain is one node a level, its blocks dependent."""
    by = dict(sig)
    top = max(by)
    nbytes = compressions = chain = 0
    for k in range(top, -1, -1):
        blocks = max(1, -(-(16 * (k < top) + by.get(k, 0)) // 16))
        nbytes += (4 * by.get(k, 0) + 32) << k
        compressions += blocks << k
        chain += blocks
    return nbytes, compressions, chain


def phase_blake2s(per_compress: float, dispatch_per_s: float, fib_code: str,
                  small_code: str) -> dict:
    """The Blake2s kernels against their plain versions on the card, bit for
    bit: the level kernel over BLAKE_COLS x children x BLAKE_SIZES, a
    length override and hash_words; the tree kernel (one launch a commit,
    against tree_plain on every level) over TREE_CASES, row-sliced columns,
    given children (hash_levels), every tree signature of a fib19_io and a
    small prove (the small program's trees and fib19_io's FRI layer trees
    also against the CPU commit), the largest fib19_io tree committed
    TREE_REPEATS times back to back, two trees back to back and a commit
    over D = 4 shards of the card; the grind against the host loop for
    POW_BITS on GRIND_DIGESTS digests. Then the compression probe (rate on
    the full card, latency on one warp), and both versions timed at the
    main path's shapes beside their bounds: the dispatch bound, the bound
    at the measured rate, and for whole trees the root chain's latency
    floor. No kernel call makes a plain call."""
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

    def tree_check(what, cols, children=None, max_log=None, cpu=False, sig=None):
        """One commit (or hash_levels from children) on the card: one tree
        launch, every level equal to tree_plain's (and the CPU's)."""
        max_log = max(cols) if max_log is None else max_log
        before = dict(K.KERNELS.launches)
        if children is None:
            layers = kernel(lambda: merkle.commit(cols)).layers
        else:
            layers = kernel(lambda: merkle.hash_levels(children, cols, max_log))
        plan = K.launch_plan([(k, m.shape[0]) for k, m in cols.items()], max_log)
        launched = {e: K.KERNELS.launches[e] - before[e] for e in K.ENTRIES}
        if launched != {"tree": len(plan), "level": 0, "grind": 0}:
            raise AssertionError(f"{what}: launches {launched}, plan {plan}")
        want = K.tree_plain(children, cols, max_log)
        if sorted(want) != sorted(layers):
            raise AssertionError(f"{what}: levels {sorted(layers)}")
        for k in want:
            same("tree", layers[k], want[k], f"{what}, level {k}")
        if cpu:
            host = merkle.hash_levels(None if children is None else children.cpu(),
                                      {k: m.cpu() for k, m in cols.items()}, max_log)
            if any(not torch.equal(host[k], layers[k].cpu()) for k in host):
                raise AssertionError(f"{what}: the card's tree != the CPU's")
        return layers

    cpu_checked = 0
    for name, sig in TREE_CASES.items():
        cols = {k: _words(rng, (c, 1 << k)) for k, c in sig.items()}
        tree_check(name, cols, cpu=max(sig) <= 12)
        cpu_checked += max(sig) <= 12
    # row slices of wider matrices (row stride 2^(k+1)), and the children
    # of a run given (the sharded top; a row slice of wider digests)
    wide = {k: _words(rng, (c + 3, 2 << k)) for k, c in {20: 4, 16: 9, 5: 2}.items()}
    tree_check("row-sliced columns", {k: m[3:, 1 << k:] for k, m in wide.items()})
    del wide
    for top, sig in ((0, {}), (2, {1: 3}), (12, {12: 2, 7: 1}), (17, {})):
        kids = _words(rng, (8, 4 << top))[:, 2 << top:]
        cols = {k: _words(rng, (c, 1 << k)) for k, c in sig.items()}
        tree_check(f"children below level {top}, columns {sig}", cols, kids, top,
                   cpu=top <= 12)
        cpu_checked += top <= 12

    # whole trees: the signatures of real proves
    trees = {"fib19_io": _recorded_signatures(fib_code, FIB_INPUT),
             "small": _recorded_signatures(small_code, SMALL_INPUT.encode())}
    for name, sigs in trees.items():
        for sig in sigs:
            cols = {k: _words(rng, (c, 1 << k)) for k, c in sig}
            fri = len(sig) == 1 and sig[0][1] == 4
            tree_check(f"{name} tree {sig}", cols, cpu=name == "small" or fri)
            cpu_checked += name == "small" or fri
            del cols
    # the largest fib19_io tree TREE_REPEATS times back to back (no sync):
    # every commit's levels equal the plain tree's
    largest = max(trees["fib19_io"], key=lambda sig: (sig[0][0], sum(c for _, c in sig)))
    cols = {k: _words(rng, (c, 1 << k)) for k, c in largest}
    want = K.tree_plain(None, cols, largest[0][0])
    before = K.KERNELS.launches["tree"]
    runs = [kernel(lambda: merkle.hash_levels(None, cols, largest[0][0]))
            for _ in range(TREE_REPEATS)]
    if K.KERNELS.launches["tree"] - before != TREE_REPEATS:
        raise AssertionError(f"{TREE_REPEATS} commits of {largest}: "
                             f"{K.KERNELS.launches['tree'] - before} tree launches")
    for r, layers in enumerate(runs):
        for k in want:
            same("tree", layers[k], want[k], f"commit {r} of {largest}, level {k}")
    del runs
    # two trees back to back, then checked; the largest over D = 4 shards
    fri_cols = {FRI_LOG: _words(rng, (4, 1 << FRI_LOG))}
    first, second = (kernel(lambda: merkle.hash_levels(None, c, max(c))) for c in (cols, fri_cols))
    for layers, c in ((first, cols), (second, fri_cols)):
        for k, w in K.tree_plain(None, c, max(c)).items():
            same("tree", layers[k], w, f"back to back, tree {max(c)}, level {k}")
    del first, second
    before = K.KERNELS.launches["tree"]
    sharded = kernel(lambda: commit_sharded(make_mesh(4, "cuda"), cols))
    if K.KERNELS.launches["tree"] - before != 5:
        raise AssertionError(f"D = 4 commit: {K.KERNELS.launches['tree'] - before} tree "
                             f"launches, not 4 shards + the top")
    for k in want:
        got = sharded.layers[k]
        same("tree", got if isinstance(got, torch.Tensor) else got.full(), want[k],
             f"D = 4 shards, level {k}")
    del cols, want, sharded, fri_cols
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
        "level_cols": BLAKE_COLS, "level_sizes": BLAKE_SIZES,
        "tree_cases": {k: sorted(v.items(), reverse=True) for k, v in TREE_CASES.items()},
        "tree_signatures": {k: [list(s) for s in v] for k, v in trees.items()},
        "repeated_tree": [list(t) for t in largest], "repeats": TREE_REPEATS,
        "trees_against_cpu": cpu_checked, "pow_bits": POW_BITS, "grind_digests": GRIND_DIGESTS,
        "comparisons": checks, "tolerance": 0, "max_abs_err": max_err})

    # the compression probe: the card's rate, one warp's latency
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_full = sms * 2048 * 4
    full_ms = _time_ms(lambda: K.KERNELS.chain(n_full, PROBE_CHAIN, "cuda"), reps=5)
    warp_ms = _time_ms(lambda: K.KERNELS.chain(32, PROBE_WARP_CHAIN, "cuda"), reps=5)
    rate = n_full * PROBE_CHAIN / (full_ms / 1e3)
    latency_s = warp_ms / 1e3 / PROBE_WARP_CHAIN
    probe = {"threads": n_full, "chain": PROBE_CHAIN, "kernel_ms": full_ms,
             "compressions_per_s": rate,
             "dispatch_compressions_per_s": dispatch_per_s / per_compress,
             "share_of_dispatch": rate * per_compress / dispatch_per_s,
             "warp_chain": PROBE_WARP_CHAIN, "warp_kernel_ms": warp_ms,
             "compression_latency_us": latency_s * 1e6}
    _line("blake2s_probe", probe)

    # times at the main path's shapes
    widest = max(((k, c, k < sig[0][0]) for sig in trees["fib19_io"] for k, c in sig),
                 key=lambda t: (t[1], t[2]))
    times = {}

    def timed(key, entry, k_fn, p_fn, nbytes, compressions, call_fn=None, chain=None):
        """kernel_ms: device time (the calls queued behind a sleep); call_ms:
        whole calls back to back (call_fn, k_fn by default), the wrapper's
        host work included."""
        same(entry, k_fn(), p_fn(), f"timed {key}")
        times[key] = {"entry": entry, "kernel_ms": _time_ms(k_fn, 10, queued=True),
                      "call_ms": _time_ms(call_fn or k_fn, reps=10),
                      "plain_ms": _time_ms(p_fn, reps=2),
                      "compressions": compressions,
                      **bound(nbytes, compressions * per_compress, dispatch_per_s),
                      "rate_bound_ms": compressions / rate * 1e3,
                      **({"root_chain": chain, "latency_floor_ms": chain * latency_s * 1e3}
                         if chain else {})}

    def timed_tree(key, sig):
        cols = {k: _words(rng, (c, 1 << k)) for k, c in sig}
        top = sig[0][0]
        nbytes, compressions, chain = _tree_work(sig)
        timed(key, "tree", lambda: merkle.hash_levels(None, cols, top)[0],
              lambda: K.tree_plain(None, cols, top)[0], nbytes, compressions,
              call_fn=lambda: merkle.commit(cols).root, chain=chain)

    timed_tree(f"tree: FRI layer of 2^{FRI_LOG} leaves", [(FRI_LOG, 4)])
    for sig in trees["fib19_io"]:
        timed_tree(f"tree: fib19_io {[list(t) for t in sig]}", sig)
    torch.cuda.empty_cache()
    leaf = _words(rng, (4, 1 << FRI_LOG))
    timed(f"level: FRI leaf (4, 2^{FRI_LOG})", "level", lambda: K.KERNELS.level(None, leaf),
          lambda: K.level_plain(None, leaf), *_level_work(False, 4, 1 << FRI_LOG))
    kids = _words(rng, (8, 2 << FRI_LOG))
    timed(f"level: digest-only 2^{FRI_LOG + 1} -> 2^{FRI_LOG}", "level",
          lambda: K.KERNELS.level(kids, None), lambda: K.level_plain(kids, None),
          *_level_work(True, 0, 1 << FRI_LOG))
    k, c, with_kids = widest
    wide = _words(rng, (c, 1 << k))
    wkids = _words(rng, (8, 2 << k)) if with_kids else None
    timed(f"level: fib19_io's widest ({c}, 2^{k}){' with children' if with_kids else ''}",
          "level", lambda: K.KERNELS.level(wkids, wide), lambda: K.level_plain(wkids, wide),
          *_level_work(with_kids, c, 1 << k))
    del wide, wkids, kids
    # the grind at pow_bits 16: whole calls (one launch and a 4-byte read)
    # beside the work the search needs, (nonce + 1) compressions at the
    # measured rate, plus one launch and 4-byte read (`launch_ms`)
    flag = torch.empty(1, dtype=torch.int32, device="cuda")
    launch_ms = _time_ms(lambda: flag.fill_(-1).item(), reps=10)
    digests = [("small_pow16", _small_pow16_digest(small_code))] + [
        (f"digest {i}", rng.integers(0, 256, 32).astype(np.uint8).tobytes())
        for i in range(GRIND_TIMED)]
    for name, digest in digests:
        nonce = kernel(lambda: K.KERNELS.grind(digest, 16, "cuda"))
        same("grind", torch.tensor(nonce), torch.tensor(_host_grinds(digest, (16,))[16]),
             f"timed grind, {name}")
        kernel_ms = _time_ms(lambda: K.KERNELS.grind(digest, 16, "cuda"), reps=10)
        work_ms = (nonce + 1) / rate * 1e3
        times[f"grind: pow_bits 16, {name} (nonce {nonce})"] = {
            "entry": "grind", "kernel_ms": kernel_ms, "call_ms": kernel_ms,
            "plain_ms": _time_ms(lambda: _plain_grind(digest, 16, "cuda"), reps=2),
            "compressions": nonce + 1, "rate_bound_ms": work_ms, "launch_ms": launch_ms,
            "bound_ms": work_ms + launch_ms, "bound_by": "operations"}
    torch.cuda.empty_cache()
    _line("blake2s_times", times)

    # hash_words, the level kernel's own path (no prove path launches it),
    # counts at 0: the channel's 40-byte messages and the FRI leaf words
    msgs = _words(rng, (10, 1 << 16))
    before = K.KERNELS.launches["level"]
    blake2s.hash_words(msgs, 40)
    blake2s.hash_words(leaf)
    hash_words_launches = K.KERNELS.launches["level"] - before
    del leaf, msgs
    return {"max_abs_err": max_err, "times": times, "probe": probe,
            "hash_words_launches": hash_words_launches}


def _clear_prover_caches() -> None:
    """Drop every cached device tensor the provers keep (air.clear_caches),
    so that a cold prove builds its own and its peak counts only them."""
    air.clear_caches()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _reset_counts() -> None:
    circle_fft.KERNEL.launches = 0
    fft.PLAIN_CUDA_CALLS = 0
    blake2s_kernels.KERNELS.launches = dict.fromkeys(blake2s_kernels.ENTRIES, 0)
    blake2s.PLAIN_CUDA_CALLS = 0
    m31_kernels.KERNELS.launches = dict.fromkeys(m31_kernels.KINDS, 0)
    m31_kernels.PLAIN_CUDA_CALLS = 0
    quotient_kernels.KERNEL.launches = 0
    quotients.PLAIN_CUDA_CALLS = 0
    constraint_kernels.KERNELS.launches = dict.fromkeys(constraint_kernels.FAMILIES, 0)
    framework.PLAIN_CUDA_CALLS = 0
    oods_kernels.KERNEL.launches = 0
    fri_kernels.KERNEL.launches = 0
    poly.PLAIN_CUDA_CALLS = 0
    fri.PLAIN_CUDA_CALLS = 0
    table_kernels.KERNEL.launches = 0
    table_kernels.PLAIN_CUDA_CALLS = 0
    device_build.META_CALLS = 0
    mesh_kernels.KERNEL.launches = 0
    mesh_kernels.PLAIN_CUDA_CALLS = 0


def _counts() -> dict:
    """The prover's kernels' launch counts: the FFT, each Blake2s entry, the
    quotient kernel, the constraint kernels, the OODS kernel, the FRI
    fold kernel, the table kernel and the mesh-stage kernel."""
    return {"fft": circle_fft.KERNEL.launches, **blake2s_kernels.KERNELS.launches,
            "quotients": quotient_kernels.KERNEL.launches,
            **constraint_kernels.KERNELS.launches, "oods": oods_kernels.KERNEL.launches,
            "fri_fold": fri_kernels.KERNEL.launches, "tables": table_kernels.KERNEL.launches,
            "mesh_stages": mesh_kernels.KERNEL.launches}


def _plain_tables() -> int:
    """The host table pass (build_meta) and the plain table build on a CUDA
    device, as run in this process: none on a prove with a card."""
    return device_build.META_CALLS + table_kernels.PLAIN_CUDA_CALLS


def _oods_fri_per_prove(launched: dict, layers: int, shards: int, oods_pulls: int,
                        what: str) -> None:
    """The OODS and fold kernels of one prove. One device: one OODS launch,
    its samples pulled once, and one fold launch a committed FRI layer plus
    the last fold (layers + 1). A mesh: one OODS launch a shard at most,
    and the fold launches between layers + 1 and a shard's each."""
    oods, folds = launched["oods"], launched["fri_fold"]
    if not shards:
        ok = oods == 1 and oods_pulls == 1 and folds == layers + 1
    else:
        ok = (1 <= oods <= shards and oods_pulls == 1
              and layers + 1 <= folds <= (layers + 1) * shards)
    if not ok:
        raise AssertionError(f"{what}: {oods} OODS launches, {oods_pulls} OODS pulls and {folds} "
                             f"fold launches for {layers} FRI layers"
                             + (f" on {shards} shards" if shards else ""))


def _constraint_launches(launched: dict) -> dict:
    return {k: launched[k] for k in constraint_kernels.FAMILIES}


def _constraints_per_prove(launched: dict, shards: int, what: str) -> None:
    """The constraint kernels of one prove. One device: composition once a
    prove, interaction once a component, no logup or scan launch. A mesh: a
    component below the sharded sizes takes one interaction launch, one
    above a logup and a scan launch a shard; composition once a device of
    the shards (every size's segments, a shard's chunks among them, in one
    launch)."""
    n = len(COMPONENT_CLASSES)
    comp, inter, logup, scan = (launched[k] for k in ("composition", "interaction", "logup",
                                                      "scan"))
    if not shards:
        ok = comp == 1 and inter == n and logup == scan == 0
    else:
        big = n - inter
        ok = (0 <= big <= n and logup == scan and big <= logup <= big * shards
              and 1 <= comp <= shards)
    if not ok:
        raise AssertionError(f"{what}: constraint launches {_constraint_launches(launched)} for "
                             f"{n} components" + (f" on {shards} shards" if shards else ""))


def _mesh_stages_per_prove(launched: int, rec, sums: int, shards: int, what: str) -> None:
    """The mesh-stage kernel of one prove: none on one device (shards 0);
    on a mesh one launch a local shard in each `fft.cross` span of the
    prove's recording (a cross-stage chunk) and one a `mesh_kernels.add_into`
    call (the composition's sum, a shard each)."""
    want = sum(1 for sp in rec.spans if sp.name == "fft.cross") * shards + sums
    if launched != want or (shards and not want):
        raise AssertionError(f"{what}: {launched} mesh-stage launches, not {want}"
                             + (f" on {shards} shards" if shards else ""))


@contextlib.contextmanager
def _counting_sums():
    """Count the mesh's in-place sums (calls of mesh_kernels.add_into)."""
    with mock.patch.object(mesh_kernels, "add_into", wraps=mesh_kernels.add_into) as add:
        yield add


def _add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in {**a, **b}}


@contextlib.contextmanager
def _counting_commits():
    """Count the Merkle trees committed inside (merkle.commit and the mesh's
    commit_sharded each build one MerkleTree)."""
    counted = {"commits": 0}
    real = merkle.MerkleTree

    class Counted(real):
        def __init__(self, *args, **kw):
            counted["commits"] += 1
            super().__init__(*args, **kw)

    with mock.patch.object(merkle, "MerkleTree", Counted):
        yield counted


def _trees_per_commit(launched: dict, commits: int, shards: int, what: str) -> dict:
    """Tree launches against commits: one a commit on one device; with
    `shards` local mesh shards at most one a shard and one for the top."""
    limit = commits * (shards + 1 if shards else 1)
    if not commits or launched["tree"] > limit:
        raise AssertionError(f"{what}: {launched['tree']} tree launches for {commits} "
                             f"commits (at most {limit})")
    return {"commits": commits, "tree_launches_per_commit": launched["tree"] / commits}


# The recording's sync counters _PhaseCalls reads, by the name it gives them.
_PULL_COUNTERS = {"pulls": "sync.decommit", "oods_pulls": "sync.oods",
                  "table_pulls": "sync.tables"}


class _PhaseCalls(air.PhaseTimer):
    """air.PhaseTimer that also records, for each phase, the device->host
    pulls of the decommitment's reads, of the OODS samples and of the table
    build's counts (the `sync.*` counters of the prove's recording,
    tracing.record, which must be active) and the mesh's collectives made
    in it (the recording's `mesh.<op>` counters)."""

    def __init__(self, device):
        super().__init__(device)
        self.calls: dict = {}
        self._seen = self._now()

    @staticmethod
    def _now() -> dict:
        counters = tracing.active().counters
        mesh = {k: v for k, v in counters.items() if k.startswith("mesh.") and k != "mesh.bytes"}
        return {k: counters.get(c, 0) for k, c in _PULL_COUNTERS.items()} | mesh

    def mark(self, name: str) -> None:
        super().mark(name)
        now = self._now()
        self.calls[name] = {k: v - self._seen.get(k, 0) for k, v in now.items()
                            if v != self._seen.get(k, 0)}
        self._seen = now


def _decommit_phase(seconds: float, calls: dict, what: str, mesh: bool = False) -> dict:
    """A prove's decommit phase: every gather served in one device->host
    pull and, on a mesh, in one `gather_many` (on the process mesh one
    all_reduce) and no other collective."""
    want = {"pulls": 1, **({"mesh.gather_many": 1} if mesh else {})}
    if calls != want:
        raise AssertionError(f"{what}: decommit made {calls}, not {want}")
    return {"s": seconds, **calls}


def _require(launched: dict, plain_fft: int, plain_blake: int, what: str,
             grind: bool = False, plain_quotients: int = 0, plain_constraints: int = 0,
             plain_oods_fri: int = 0, plain_tables: int = 0) -> dict:
    """A prove's launches: the FFT, the Blake2s tree kernel, the quotient
    kernel, the composition kernel, the LogUp interaction (the
    interaction kernel, or on a mesh's shards the logup kernel and the
    scan), the OODS kernel, the fold kernel and the table kernel, and the
    grind where pow_bits > 13, launched; no plain FFT, Blake2s, quotient,
    constraint, OODS, fold or table call on a CUDA tensor and no host
    table pass."""
    needed = (("fft", "tree", "quotients", "composition", "oods", "fri_fold", "tables")
              + (("grind",) if grind else ()))
    missing = [k for k in needed if launched.get(k, 0) <= 0]
    if launched.get("interaction", 0) <= 0 and (launched.get("logup", 0) <= 0
                                                or launched.get("scan", 0) <= 0):
        missing.append("interaction (or logup and scan)")
    if missing:
        raise AssertionError(f"{what}: not launched: {missing} ({launched})")
    if plain_fft:
        raise AssertionError(f"{what}: the plain FFT ran on a CUDA tensor")
    if plain_blake:
        raise AssertionError(f"{what}: the plain Blake2s ran on a CUDA tensor")
    if plain_quotients:
        raise AssertionError(f"{what}: the plain quotient accumulation ran on a CUDA tensor")
    if plain_constraints:
        raise AssertionError(f"{what}: the plain constraint path (the Expr evaluation, the "
                             f"fractions or the prefix sum) ran on a CUDA tensor "
                             f"{plain_constraints} times")
    if plain_oods_fri:
        raise AssertionError(f"{what}: the plain OODS sampling or FRI fold ran on a CUDA tensor "
                             f"{plain_oods_fri} times")
    if plain_tables:
        raise AssertionError(f"{what}: the host table pass or the plain table build ran "
                             f"{plain_tables} times")
    return launched


def _require_here(launched: dict, what: str, grind: bool = False) -> dict:
    """_require with this process's plain-call counts."""
    return _require(launched, fft.PLAIN_CUDA_CALLS, blake2s.PLAIN_CUDA_CALLS, what, grind,
                    quotients.PLAIN_CUDA_CALLS, framework.PLAIN_CUDA_CALLS,
                    poly.PLAIN_CUDA_CALLS + fri.PLAIN_CUDA_CALLS, _plain_tables())


def _check_launches(before: dict, what: str, grind: bool = False) -> dict:
    now = _counts()
    launched = _require_here({k: now[k] - before[k] for k in now}, what, grind)
    if any(m31_kernels.KERNELS.launches.values()) or m31_kernels.PLAIN_CUDA_CALLS:
        raise AssertionError(f"{what}: an M31 kernel or plain M31 op ran on the prover path")
    if mesh_kernels.PLAIN_CUDA_CALLS:
        raise AssertionError(f"{what}: a plain mesh stage ran on a CUDA tensor "
                             f"{mesh_kernels.PLAIN_CUDA_CALLS} times")
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
                "quotient_launches": launched["quotients"],
                "constraint_launches": _constraint_launches(launched),
                "oods_launches": launched["oods"], "fold_launches": launched["fri_fold"],
                "table_launches": launched["tables"],
                **({"matches_cpu_proof": True} if pow16 else {})})
    return launched


def phase_program(name, path, inp, runs: int, expect_sha: str | None,
                  n_shards: int = 0, fresh_verify: bool = False, config=None,
                  tag: str | None = None, recorded: str | None = None) -> dict:
    """Prove (`runs` times, the first cold) and verify one program at
    `config` (the prover's default if None); on a mesh of `n_shards` shards
    over the visible cards if n_shards > 0. With fresh_verify, the last
    proof is also verified by the CLI in a new process (`fresh_verify`
    line). Every proof of the program must have the same sha256 (expect_sha
    if given). Above 13 pow_bits each prove must launch the grind kernel
    exactly once (one batch of nonces)."""
    with open(path) as f:
        code = compile_program(f.read())
    mesh = make_mesh(n_shards, "cuda") if n_shards else None
    where = {"shards": n_shards, "devices": sorted({str(d) for d in mesh.devices})} if mesh else {}
    grind = config is not None and config.pow_bits > 13
    launched = 0
    shas = set()
    for run in range(runs):
        machine = create_test_machine(code, inp)
        t0 = time.perf_counter()
        machine.execute()
        steps = len(machine.trace())
        torch.cuda.reset_peak_memory_stats()
        before = _counts()
        with tracing.record(run) as rec, _counting_commits() as counted, _counting_sums() as sums:
            timer = _PhaseCalls("cuda")
            t1 = time.perf_counter()
            proof = air.prove_brainfuck(machine, config, device="cuda", timer=timer, mesh=mesh)
            torch.cuda.synchronize()
            prove_s = time.perf_counter() - t1
        launched = _check_launches(before, f"{name} prove", grind=grind)
        _mesh_stages_per_prove(launched["mesh_stages"], rec, sums.call_count,
                               len(mesh.local) if mesh else 0, f"{name} prove")
        _constraints_per_prove(launched, len(mesh.local) if mesh else 0, f"{name} prove")
        if launched["tables"] != 1 or timer.calls["tables"].get("table_pulls") != 1:
            raise AssertionError(f"{name} prove: {launched['tables']} table launches and "
                                 f"{timer.calls['tables']} in its tables phase, not one each")
        if grind and launched["grind"] != 1:
            raise AssertionError(f"{name} prove: {launched['grind']} grind launches, not one")
        trees = _trees_per_commit(launched, counted["commits"], len(mesh.local) if mesh else 0,
                                  f"{name} prove")
        decommit = _decommit_phase(timer.seconds["decommit"], timer.calls["decommit"],
                                   f"{name} prove", mesh=mesh is not None)
        _oods_fri_per_prove(launched, len(proof["fri"]["layer_roots"]),
                            len(mesh.local) if mesh else 0,
                            timer.calls["oods"].get("oods_pulls", 0), f"{name} prove")
        peak = torch.cuda.max_memory_allocated()
        peak_requested = torch.cuda.memory_stats().get("requested_bytes.all.peak")
        t2 = time.perf_counter()
        air.verify_brainfuck(proof, device="cuda")
        verify_s = time.perf_counter() - t2
        sha = proof_sha256(proof)
        if expect_sha is not None and sha != expect_sha:
            raise AssertionError(f"{name} proof sha256 {sha} != JAX reference")
        if recorded is not None and sha != RECORDED_SHA256[recorded]:
            raise AssertionError(f"{name} proof sha256 {sha} != the recorded {recorded} proof")
        shas.add(sha)
        if len(shas) != 1:
            raise AssertionError(f"{name}: two proves of one execution differ: {sorted(shas)}")
        _line(tag or ("sharded" if mesh else name), {
            **({"program": name, **where} if mesh or tag else {}),
            **({"pcs_config": config.to_json()} if config is not None else {}),
            "run": "cold" if run == 0 else "warm", "vm": machine.vm, "steps": steps,
            "vm_s": t1 - t0, "prove_s": prove_s, "verify_s": verify_s,
            "khz": steps / prove_s / 1e3, "proof_bytes": len(json.dumps(proof)),
            "claim_max_log": max(proof["claim"].values()),
            "phases_s": timer.seconds, "decommit": decommit, "peak_device_bytes": peak,
            "peak_requested_bytes": peak_requested, "fft_launches": launched["fft"],
            "blake2s_launches": {k: launched[k] for k in blake2s_kernels.ENTRIES},
            "quotient_launches": launched["quotients"],
            "constraint_launches": _constraint_launches(launched),
            "oods_launches": launched["oods"], "fold_launches": launched["fri_fold"],
            "table_launches": launched["tables"], "mesh_stage_launches": launched["mesh_stages"],
            **trees, "sha256": sha, "matches_jax": None if expect_sha is None else True,
            **({"matches_recorded": True} if recorded else {}),
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
    """One more warm prove of the program under torch.profiler, recorded
    (tracing.record: its spans are `bf.` profiler ranges, which do not
    synchronize, so only the prove's own synchronizations): the device-busy
    share (the union of kernel and copy intervals over the prove's wall
    time), the host synchronizations the prove makes (the profiler's
    synchronize calls beside the recording's `sync.*` counters) and the
    time spent waiting in them, the kernels that take the most device time,
    the interpreter's garbage-collection pauses (`gc` spans), the device's
    idle time by the innermost span open through it (tracing.idle_by_span),
    and the decommit phase: its seconds, device->host pulls (one: every
    gather in one copy; also read as the device-to-host copies in its
    range), host syncs and collection pauses; and the tables phase: its
    seconds, host syncs (one: the counts' pull), device-to-host copies (one)
    and host-to-device copies issued in it (two: the staged trace and the
    kernel's launch table)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with open(path) as f:
        machine = create_test_machine(compile_program(f.read()), inp)
    machine.execute()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracing.record(0) as rec:
            t0 = time.perf_counter()
            air.prove_brainfuck(machine, device="cuda")
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    prefix = tracing.PROFILER_PREFIX
    ranges, spans, syncs, wait_us, by_kernel, kernels = [], [], {}, 0.0, {}, 0
    sync_at, dtoh_at, htod_at, decommit, tables_at = [], [], [], None, None
    for ev in prof.events():
        if ev.name.startswith(prefix):  # the spans (on the host, and their device annotations)
            if ev.device_type == DeviceType.CPU:
                ranges.append((ev.time_range.start, ev.time_range.end, ev.name[len(prefix):]))
                if ev.name == prefix + "decommit":
                    decommit = ev.time_range
                if ev.name == prefix + "tables":
                    tables_at = ev.time_range
        elif ev.device_type == DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
            kernels += not ev.name.startswith(("Memcpy", "Memset"))
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            if ev.name.startswith("Memcpy DtoH"):
                dtoh_at.append(ev.time_range.start)
        elif "Synchronize" in ev.name:
            syncs[ev.name] = syncs.get(ev.name, 0) + 1
            wait_us += ev.time_range.elapsed_us()
            sync_at.append(ev.time_range.start)
        if ev.device_type == DeviceType.CPU and ev.kernels:
            # a host-to-device copy counts where the host op that issued it
            # started (the launch table's copy may start on the card after
            # the phase's range has closed)
            htod_at += [ev.time_range.start for k in ev.kernels
                        if k.name.startswith("Memcpy HtoD")]
    if decommit is None or tables_at is None:
        raise AssertionError(f"{name}: no decommit or tables range among the profiler's events")
    if len(ranges) != len(rec.spans):
        raise AssertionError(f"{name}: {len(ranges)} bf. ranges for {len(rec.spans)} spans")
    busy_us, end, gaps = 0.0, None, []
    for a, b in sorted(spans):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    phase = tracing.phase_of([(sp.start_ns, sp.end_ns, sp.name) for sp in rec.spans])

    def in_phase(span_name: str, ph: str) -> list:
        return [sp for sp, p in zip(rec.spans, phase) if sp.name == span_name and p == ph]

    def gc_s(ph: str) -> float:
        return sum(sp.end_ns - sp.start_ns for sp in in_phase("gc", ph)) / 1e9

    inside = lambda ts: sum(decommit.start <= t <= decommit.end for t in ts)  # noqa: E731
    split = {"s": decommit.elapsed_us() / 1e6, "pulls": len(in_phase("sync.decommit", "decommit")),
             "device_to_host_copies": inside(dtoh_at), "host_syncs": inside(sync_at),
             "gc_s": gc_s("decommit")}
    if split["pulls"] != 1 or split["device_to_host_copies"] != 1:
        raise AssertionError(f"{name}: decommit made {split}, not one pull")
    within = lambda ts: sum(tables_at.start <= t <= tables_at.end for t in ts)  # noqa: E731
    table_split = {"s": tables_at.elapsed_us() / 1e6, "host_syncs": within(sync_at),
                   "device_to_host_copies": within(dtoh_at),
                   "host_to_device_copies": within(htod_at), "gc_s": gc_s("tables")}
    if (table_split["host_syncs"] != 1 or table_split["device_to_host_copies"] != 1
            or table_split["host_to_device_copies"] != 2):
        raise AssertionError(f"{name}: the tables phase made {table_split}, not one sync, one "
                             f"pull and two uploads (the staged trace, the launch table)")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    own = tracing.self_times([rec])
    idle = sorted(tracing.idle_by_span(gaps, ranges).items(), key=lambda kv: -kv[1])[:10]
    out = {"program": name, "run": "warm, profiled", "prove_s": wall_s,
           "device_busy_s": busy_us / 1e6 if spans else None,
           "device_busy_share": busy_us / 1e6 / wall_s if spans else "not measured",
           "device_events": len(spans), "device_kernels": kernels,
           "host_syncs": sum(syncs.values()), "syncs_by_call": syncs,
           "syncs_counted": tracing.sync_counts([rec]),
           "sync_wait_s": wait_us / 1e6, "gc_s": own.get("gc", 0) / 1e9, "decommit": split,
           "tables": table_split, "spans": len(rec.spans),
           "idle_by_span_ms": {k: v / 1e3 for k, v in idle},
           "top_device_us": dict(top)}
    _line("phase_split", out)
    return out


def production_extends(fib_path: str) -> list:
    """The fused extends a PRODUCTION prove of fib19_io at input 19 launches:
    (columns, n) of each (tree, trace size) group of its main, interaction
    and composition trees (air.build_layout of its claim), each blown up by
    PRODUCTION.log_blowup; the composition's is (4, 2^24) -> 2^28."""
    with open(fib_path) as f:
        machine = create_test_machine(compile_program(f.read()), FIB_INPUT)
    machine.execute()
    claim = device_build.device_meta(machine.trace(), machine.program(), "cuda").claim
    layout = air.build_layout(claim, PRODUCTION)
    groups: dict = {}
    for ti in (1, 2, 3):
        for meta in layout.trees[ti]:
            groups[(ti, meta.log_size)] = groups.get((ti, meta.log_size), 0) + 1
    return sorted({(cols, n) for (_, n), cols in groups.items()}, key=lambda s: (s[1], s[0]))


def phase_production_fft(shapes: list) -> dict:
    """The fused extend kernel against its plain version on the card, bit
    for bit, at every production extend shape (blowup PRODUCTION.log_blowup),
    each shape on fresh random values; the largest also timed after a
    warm-up (the kernel's mean of three runs, the plain version's one)."""
    rng = np.random.default_rng(3)
    blowup = PRODUCTION.log_blowup
    max_err = 0
    times = {}
    for cols, n in shapes:
        x = torch.as_tensor(rng.integers(0, P, (cols, 1 << n)).astype(np.int32), device="cuda")
        launches = circle_fft.KERNEL.launches
        got = fft.extend_with_coeffs(x, n, blowup)
        if circle_fft.KERNEL.launches - launches != len(
                circle_fft.launch_plan("extend", n, cols, blowup)):
            raise AssertionError(f"production extend ({cols}, 2^{n}): launches differ from its plan")
        want = fft.extend_plain(x, n, blowup)
        for g, w, what in zip(got, want, ("coefficients", "extension")):
            err = 0 if torch.equal(g, w) else int((g.to(torch.int64) - w).abs().max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"production extend ({cols}, 2^{n}) -> 2^{n + blowup}: "
                                     f"kernel != plain in the {what}")
        del got, want
        if (cols, n) == shapes[-1]:
            times[f"extend ({cols}, 2^{n}) blowup {blowup}"] = {
                "kernel_ms": _time_ms(lambda: fft.extend_with_coeffs(x, n, blowup), reps=3),
                "plain_ms": _time_ms(lambda: fft.extend_plain(x, n, blowup), reps=1)}
        del x
        _clear_prover_caches()
    out = {"shapes": [[c, n] for c, n in shapes], "log_blowup": blowup,
           "comparisons": 2 * len(shapes), "tolerance": 0, "max_abs_err": max_err,
           "times": times}
    _line("production_fft", out)
    return out


def quotient_work(n: int, n_cols: int, groups, offset: int = 0) -> tuple:
    """(bytes, M31 products) of the quotient at n positions: each column
    word read once and the (4, n) output written once; a position's circle
    step (4 products; a walk's start, two circle multiplications a thread,
    shared by its K points) and, a group, 4 products a member for the
    weighted sum, QUOTIENT_GROUP_PRODUCTS for the rest and one M31 inversion
    a batch of K points (csrc/quotients.cu's schedule)."""
    k, walk, _ = quotient_kernels.schedule(len(groups), offset, n)
    per_point = 4 + (8 / k if walk else 0) + sum(
        4 * len(idxs) + QUOTIENT_GROUP_PRODUCTS + M31_INV_PRODUCTS / k for _, _, idxs in groups)
    return n * (4 * n_cols + 16), n * per_point


def phase_quotients(fib_path: str, per_mul: float, dispatch_per_s: float) -> dict:
    """The quotient kernel against its plain version on the card, bit for
    bit, at every quotient shape of a fib19_io prove (input 19) at the
    default config and at PRODUCTION: each launch's inputs, as the prove
    gives them, also go through the plain version (quotients.accumulate_plain,
    in ranges of 2^QUOTIENT_CHUNK_LOG positions). Every default shape and
    the production shapes of 2^QUOTIENT_TIMED_LOG positions are timed (the
    kernel's mean of five calls, the plain version's one pass over the
    ranges) beside the bounds: `ms` device time (the calls queued behind a
    sleep), `call_ms` whole calls back to back. Both proofs verify; the
    default one carries the JAX package's sha256."""
    K = quotient_kernels.KERNEL
    real = K.accumulate
    shapes, times = [], {}
    max_err = 0
    config_name = None

    def plain(log_size, columns, groups, offset):
        n = columns[0].shape[0]
        step = min(n, 1 << QUOTIENT_CHUNK_LOG)
        return [quotients.accumulate_plain(log_size, [c[s:s + step] for c in columns], groups,
                                           offset + s) for s in range(0, n, step)]

    sched = (ctypes.c_longlong * 3)()

    def checked(log_size, columns, groups, offset=0):
        nonlocal max_err
        out = real(log_size, columns, groups, offset)
        n = out.shape[1]
        K.lib.load().quotients_schedule(len(groups), offset, n, ctypes.addressof(sched))
        if (sched[0], bool(sched[1]), sched[2]) != quotient_kernels.schedule(len(groups), offset,
                                                                             n):
            raise AssertionError(f"quotient schedule at 2^{log_size} ({offset}, {n}): kernel "
                                 f"{tuple(sched)}, wrapper "
                                 f"{quotient_kernels.schedule(len(groups), offset, n)}")
        step = min(n, 1 << QUOTIENT_CHUNK_LOG)
        for s, want in zip(range(0, n, step), plain(log_size, columns, groups, offset)):
            err = int((out[:, s:s + step].to(torch.int64) - want.to(torch.int64)).abs().max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"quotient kernel != plain at 2^{log_size}, positions "
                                     f"{offset + s} .. {offset + s + step - 1}")
        key = (f"{config_name} 2^{log_size}: {len(columns)} columns, groups of "
               f"{[len(g[2]) for g in groups]}")
        shapes.append(key)
        if config_name == "default" or log_size >= QUOTIENT_TIMED_LOG:
            nbytes, products = quotient_work(n, len(columns), groups, offset)
            call = lambda: real(log_size, columns, groups, offset)  # noqa: E731
            times[key] = {
                "ms": _time_ms(call, reps=5, queued=True), "call_ms": _time_ms(call, reps=5),
                "plain_ms": _time_ms(lambda: plain(log_size, columns, groups, offset), reps=1),
                "positions": n, "products": products,
                "schedule": dict(zip(("k", "walk", "stride"),
                                     quotient_kernels.schedule(len(groups), offset, n))),
                **bound(nbytes, products * per_mul, dispatch_per_s)}
        return out

    with open(fib_path) as f:
        code = compile_program(f.read())
    with mock.patch.object(K, "accumulate", checked):
        for config_name, config in (("default", None), ("production", PRODUCTION)):
            _clear_prover_caches()
            machine = create_test_machine(code, FIB_INPUT)
            machine.execute()
            proof = air.prove_brainfuck(machine, config, device="cuda")
            if config is None and proof_sha256(proof) != REFERENCE_SHA256["fib19_io"]:
                raise AssertionError("fib19_io proof under the quotient check != JAX reference")
            air.verify_brainfuck(proof, device="cuda")
            del proof
    _clear_prover_caches()
    out = {"shapes": shapes, "comparisons": len(shapes), "tolerance": 0, "max_abs_err": max_err,
           "chunk_log": QUOTIENT_CHUNK_LOG, "times": times}
    _line("quotients", out)
    return out


OODS_REPLACES = "stwo_brainfuck_tpu/core/poly.py:76 (_sample_tensor_jit)"
FOLD_REPLACES = ("stwo_brainfuck_tpu/core/fri.py:67 (_fold_jit), :77 (_fold2_jit), "
                 ":85 (_fold_add_jit)")
TABLES_REPLACES = "stwo_brainfuck_tpu/components/device_build.py:176 (_build_tables_jit)"
CHECK_SHARDS = 4  # the OODS and fold checks' shard chunks
FOLD_PRODUCTS = 24  # a fold: 4 (a + b) / 2, 4 (a - b) itw, 16 beta (a - b) itw


def oods_work(groups) -> tuple:
    """(bytes, M31 products) of one OODS launch: each coefficient word read
    once (a column opened at several points is one row) and the (4, rows)
    output written once; 4 products a coefficient and point (its word times
    a QM31 b_hi). The products of the bases and of a thread's sum times
    b_lo are left out: the bound is a floor."""
    columns = sum(len(r) for _, _, r in groups)
    sampled = [r for _, _, rs in groups for r in rs if r is not None]
    distinct = {(r.data_ptr(), int(r.shape[0])): int(r.shape[0]) for r in sampled}
    return (4 * sum(distinct.values()) + 16 * columns,
            4 * sum(int(r.shape[0]) for r in sampled))


def fold_work(step, n: int, has_a: bool, has_b: bool) -> tuple:
    """(bytes, M31 products) of one fold launch of n outputs: each input
    word read once (the values, the injected inputs, one twiddle word a
    pair), the (4, n) output written once; FOLD_PRODUCTS a fold and the
    twiddles' inversion (3 products a twiddle and one m31 inversion a
    thread's K x T twiddles)."""
    tws = sum(fri_kernels.pairs_per_output(step, use) for use, _, _ in step.twiddles(has_a, has_b))
    folds = {0: 0, 1: 1, 2: 3}[step.folds] + 2 * has_a + has_b
    nbytes = n * (16 * (1 << step.folds) + 64 * has_a + 32 * has_b + 4 * tws + 16)
    k = fri_kernels.OUTPUTS_PER_THREAD
    inverse = tws * 3 + M31_INV_PRODUCTS / k
    return nbytes, n * (FOLD_PRODUCTS * folds + inverse)


def oods_device_ms(kernel, groups, want: torch.Tensor, shard: int = 0, reps: int = 5) -> float:
    """The OODS kernel's device time on `groups` (one launch's worth)
    without its call's host part: the table planned and staged once, one
    launch checked against `want`, then `reps` launches back to back
    between two events."""
    dev = want.device
    lp = oods_kernels.plan(groups, shard, kernel.max_blocks)
    table = torch.as_tensor(lp.words.view(np.int32), device=dev)
    out = torch.empty_like(want)
    kernel.enqueue(lp, table, out)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError("OODS launch on a staged table != the wrapper's")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        kernel.enqueue(lp, table, out)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _err(got: torch.Tensor, want: torch.Tensor) -> int:
    return 0 if torch.equal(got, want) else int(
        (got.to(torch.int64) - want.to(torch.int64)).abs().max())


def _chunk(x, i: int, c: int):
    """Chunk i of c positions of a (4, m) array (None stays None)."""
    return None if x is None else x[:, i * c:(i + 1) * c]


def phase_oods_fri(fib_path: str, big_path: str, per_mul: float, dispatch_per_s: float) -> dict:
    """The OODS kernel and the fold kernel against their plain versions on
    the card, bit for bit, on the inputs of three proves (fib19_io at the
    default config, big22, fib19_io at PRODUCTION: every OODS group shape
    and every fold step, the 2^28-position circle fold included): each
    launch's inputs also go through the plain version (poly.sample_groups_plain,
    fri.fold_step_plain, int64 on the card) and, as a mesh shard's chunk,
    through the kernel again (OODS: every row in CHECK_SHARDS chunks, each
    chunk's launch at its offset, their sums against the whole; folds: the
    second of CHECK_SHARDS output chunks at its offset). Each launch is
    timed (device time: an OODS launch on a table staged once, a fold's
    calls queued behind a sleep; an OODS call's whole time too, and its
    host part, the call's time less the launch's) beside its bounds and the
    plain version's one call; the line also gives the OODS kernel's
    registers, static shared memory and spills. Each proof keeps its
    sha256."""
    real_sample, real_fold = poly.sample_groups, fri.fold_step
    times = {}
    max_err = 0
    tag = None

    def check(what, got, want):
        nonlocal max_err
        err = _err(got, want)
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"{what}: kernel != plain (max abs err {err})")

    def sample(groups, shard=0):
        got = real_sample(groups, shard)
        what = (f"{tag} oods: {len(groups)} groups, {sum(len(r) for _, _, r in groups)} rows, "
                f"2^{max(lg for lg, _, _ in groups)} largest")
        check(what, got, poly.sample_groups_plain(groups, shard))
        parts = []
        for i in range(CHECK_SHARDS):
            gs = [(lg, pt, [r.narrow(0, i * (r.shape[0] // CHECK_SHARDS),
                                     r.shape[0] // CHECK_SHARDS)
                            if r.shape[0] >= CHECK_SHARDS else (r if i == 0 else None)
                            for r in rows]) for lg, pt, rows in groups]
            part = real_sample(gs, shard=i)
            check(f"{what}, shard {i}", part, poly.sample_groups_plain(gs, shard=i))
            parts.append(part.to(torch.int64))
        check(f"{what}, {CHECK_SHARDS} shards summed", (sum(parts) % P).to(torch.int32), got)
        nbytes, products = oods_work(groups)
        ms = oods_device_ms(oods_kernels.KERNEL, groups, got, shard)
        call_ms = _time_ms(lambda: real_sample(groups, shard))
        times[what] = {
            "groups": [[lg, len(r)] for lg, _, r in groups], "bytes": nbytes,
            "ms": ms, "call_ms": call_ms, "host_ms": call_ms - ms,
            "plain_ms": _time_ms(lambda: poly.sample_groups_plain(groups, shard), reps=1),
            **bound(nbytes, products * per_mul, dispatch_per_s)}
        return got

    def fold(values, step, inject_a=None, inject_b=None, offset=0):
        got = real_fold(values, step, inject_a, inject_b, offset)
        n = got.shape[1]
        what = (f"{tag} fold: level {step.level} -> {step.out_level} ({step.folds} folds"
                f"{', circle' if step.circle else ''}{', inject_a' if inject_a is not None else ''}"
                f"{', inject_b' if inject_b is not None else ''})")
        check(what, got, fri.fold_step_plain(values, step, inject_a, inject_b, offset))
        if n >= 2 * CHECK_SHARDS:
            c = n // CHECK_SHARDS
            part = real_fold(_chunk(values, 1, c << step.folds), step, _chunk(inject_a, 1, 4 * c),
                             _chunk(inject_b, 1, 2 * c), offset + c)
            check(f"{what}, chunk 1 of {CHECK_SHARDS}", part, got[:, c:2 * c])
        nbytes, products = fold_work(step, n, inject_a is not None, inject_b is not None)
        times[what] = {
            "outputs": n, "bytes": nbytes,
            "ms": _time_ms(lambda: real_fold(values, step, inject_a, inject_b, offset),
                           queued=True),
            "plain_ms": _time_ms(lambda: fri.fold_step_plain(values, step, inject_a, inject_b,
                                                             offset), reps=1),
            **bound(nbytes, products * per_mul, dispatch_per_s)}
        return got

    proves = (("fib19_io", fib_path, FIB_INPUT, None, REFERENCE_SHA256["fib19_io"]),
              ("big22", big_path, b"", None, RECORDED_SHA256["big22"]),
              ("production", fib_path, FIB_INPUT, PRODUCTION,
               RECORDED_SHA256["fib19_io_in19_production"]))
    for tag, path, inp, config, sha in proves:
        _clear_prover_caches()
        with open(path) as f:
            machine = create_test_machine(compile_program(f.read()), inp)
        machine.execute()
        with mock.patch.object(poly, "sample_groups", sample), \
                mock.patch.object(fri, "fold_step", fold):
            proof = air.prove_brainfuck(machine, config, device="cuda")
        if proof_sha256(proof) != sha:
            raise AssertionError(f"{tag} (OODS and fold checks): sha256 {proof_sha256(proof)}")
        del proof
    _clear_prover_caches()
    out = {"comparisons": len(times), "tolerance": 0, "max_abs_err": max_err,
           "oods_kernel": oods_kernels.KERNEL.attributes(), "times": times}
    _line("oods_fri", out)
    return out


def _constraint_bound(component, family: str, rows: int, per_mul: float, dispatch_per_s: float,
                      batch: int = constraint_kernels.BATCH_ROWS) -> dict:
    """A logup, interaction or scan launch's bounds: bytes (each input word
    read once, each output word written once) at the memory rate; the M31
    products the function needs (the program's distinct ops, the inverses
    batched as the kernels batch them, or each on its own with batch 0:
    constraint_kernels.launch_work) at per_mul instructions and its adds at
    2 at the dispatch rate."""
    nbytes, products, adds = constraint_kernels.launch_work(component, family, rows, batch)
    return {"products": products, "adds": adds,
            **bound(nbytes, products * per_mul + 2 * adds, dispatch_per_s)}


def _rows_like(gen, count: int, m: int, dev, edge: bool) -> list:
    """`count` int32 rows of m canonical values on `dev`: uniform from the
    generator, or edge values (0, 1, p - 2, p - 1) with 0 and p - 1 in
    every row."""
    if not edge:
        return [torch.randint(0, P, (m,), generator=gen, dtype=torch.int32, device=dev)
                for _ in range(count)]
    values = torch.tensor([0, 1, P - 2, P - 1], dtype=torch.int32, device=dev)
    rows = []
    for _ in range(count):
        r = values[torch.randint(0, 4, (m,), generator=gen, device=dev)]
        r[0], r[-1] = 0, P - 1
        rows.append(r)
    return rows


def _felt(rng) -> tuple:
    return tuple(int(v) for v in rng.integers(0, P, 4))


def _elements(rng) -> dict:
    return {k: framework.LookupElements(z=_felt(rng), alpha=_felt(rng), size=size)
            for k, size in ELEMENT_SIZES.items()}


def zero_den_elements(component, main_cols: dict, elements: dict, rows: list) -> dict:
    """`elements` with z moved so that relation k's denominator is 0 at
    storage row rows[k % len(rows)]: its element set's z becomes the
    combination of that row's values (a set shared by relations takes the
    first's)."""
    program = framework.constraint_program(type(component))
    zero = {k: framework.LookupElements(z=(0, 0, 0, 0), alpha=e.alpha, size=e.size)
            for k, e in elements.items()}
    dev = next(iter(main_cols.values())).device
    idx = torch.tensor(rows, dtype=torch.int64, device=dev)
    inv = program.inversions()
    vals = framework.emulate(program, {
        "cols": [main_cols[c][idx] for c in component.columns],
        "is_first": (idx == 0).to(torch.int64), "elements": zero}, [d for d, _ in inv])
    out = dict(elements)
    moved = set()
    for k, (d, _) in enumerate(inv):
        name = program.relations[k][0]
        if name not in moved:
            moved.add(name)
            e = elements[name]
            z = tuple(int(v) for v in vals[d][:, k % len(rows)].cpu())
            out[name] = framework.LookupElements(z=z, alpha=e.alpha, size=e.size)
    return out


def phase_constraints(fib_path: str, big_path: str, per_mul: float,
                      dispatch_per_s: float) -> dict:
    """The constraint kernels against their plain versions on the card, bit
    for bit, for every component: the composition kernel (one launch a
    prove, every size a segment) against the Expr path summed a size
    (framework.composition_segment_plain); the interaction kernel (the whole LogUp interaction trace: Q_k, S
    and the claimed sum) against framework.interaction_plain; on the same
    inputs the mesh's pair, the logup kernel against logup_fractions_plain
    and the LogUp scan against prefix_sum_plain:

    - on the prove's own inputs, recorded from a default fib19_io prove, a
      big22 prove and a PRODUCTION fib19_io prove at input 19 (the
      composition launch's segments also through the plain version in
      ranges of 2^CONSTRAINT_CHUNK_LOG rows); every shape and the
      composition launch timed (the kernel's device time behind a sleep,
      mean of 5; the composition call's host part, `host_ms`; the plain
      version's one pass) beside its bounds, the interaction beside the
      logup + scan pair on its inputs (`pair_ms`);
    - at each of those shapes (the composition: the prove's segments) on
      random canonical inputs and on edge values (0, 1, p - 2, p - 1, with
      0 and p - 1 in every row; the lookup elements' z moved so that some
      denominators are 0) from a numpy seed, the kernel over the whole
      shape and the plain version (the composition and logup kernels: on
      its first and last 2^CONSTRAINT_SAMPLE_LOG rows, all of a smaller
      shape);
    - the default fib19_io composition launch also as CONSTRAINT_CHUNKS
      chunks a segment in one launch (their offsets, S(p - g) given as rows
      as the mesh gives them and through the rotation index) against the
      whole launch; the scan's as
      CONSTRAINT_CHUNKS linear chunks, each launch's carry the claimed sum
      of the one before, against the plain prefix sum in linear order.
    The scan is timed as the mesh runs it, the second of MESH_SHARDS
    linear chunks with the first chunk's sum as its carry (checked against
    the plain prefix sum), and in coset mode (`off_path`: no prove path
    runs it), each beside torch.cumsum (int64) of the same rows, one
    PyTorch call of the same prefix sum before its % p (`library_ms`); on
    edge inputs it also takes edge-valued row sums (both modes). The
    proofs carry their recorded sha256s and verify."""
    K = constraint_kernels.KERNELS
    real_comp, real_inter = K.composition, K.interaction
    real_logup, real_scan = K.logup, K.scan
    shapes: dict = {}
    times: dict = {}
    max_err = 0
    prove = None

    def same(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
        nonlocal max_err
        err = int((got.to(torch.int64) - want.to(torch.int64) % P).abs().max())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"constraint kernel != plain: {what}")

    def plain_ranges(m: int, sample: bool) -> list:
        step = 1 << (CONSTRAINT_SAMPLE_LOG if sample else CONSTRAINT_CHUNK_LOG)
        if m <= step:
            return [slice(0, m)]
        if sample:
            return [slice(0, step), slice(m - step, m)]
        return [slice(s, s + step) for s in range(0, m, step)]

    def check_composition(what, args, outs, sample=False):
        """outs: the kernel's (4, m) result a segment of composition(*args),
        against framework.composition_plain summed a segment (in ranges of
        rows at their offsets). Returns the plain ms."""
        segments, els, alpha, blow = args
        plain_ms = 0.0
        for k, seg in enumerate(segments):
            for sl in plain_ranges(seg.is_first.shape[0], sample):
                part = framework.CompositionSegment(
                    seg.log_size, [framework.CompositionMember(
                        m.component, {c: v[sl] for c, v in m.main_cols.items()},
                        [r[sl] for r in m.inter_rows],
                        m.s_rows if seg.rotation is not None else [r[sl] for r in m.s_rows],
                        m.claimed_sum, m.alpha_offset) for m in seg.members],
                    seg.is_first[sl], seg.rotation, seg.offset + sl.start)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                want = framework.composition_segment_plain(part, els, alpha, blow)
                end.record()
                torch.cuda.synchronize()
                plain_ms += start.elapsed_time(end)
                same(f"{what}, segment 2^{seg.log_size} rows {sl.start} .. {sl.stop - 1}",
                     outs[k][:, sl], want)
                del want
        return plain_ms

    def check_logup(what, args, q, total, sample=False):
        component, main, isf, els = args
        ranges = plain_ranges(isf.shape[0], sample)
        wants = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for sl in ranges:
            wants.append(framework.logup_fractions_plain(
                component, {k: v[sl] for k, v in main.items()}, isf[sl], els))
        end.record()
        torch.cuda.synchronize()
        for sl, (wq, wt) in zip(ranges, wants):
            same(f"{what} Q, rows {sl.start} .. {sl.stop - 1}", q[:, :, sl], wq)
            same(f"{what} total, rows {sl.start} .. {sl.stop - 1}", total[:, sl], wt)
        return start.elapsed_time(end)

    def check_interaction(what, args, got):
        """The interaction kernel's (Q, S, claimed) of args against
        interaction_plain; returns the plain ms."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = framework.interaction_plain(*args)
        end.record()
        torch.cuda.synchronize()
        for name, g, w in zip(("Q", "S", "claimed sum"), got, want):
            same(f"{what} {name}", g, w)
        return start.elapsed_time(end)

    def check_scan(what, total, s, claimed):
        """The scan's (S, claimed) of total in coset order against the
        plain prefix sum; returns the plain ms."""
        perm = fft.coset_order_permutation(total.shape[1].bit_length() - 1, total.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want, want_claimed = framework.prefix_sum_plain(total, perm)
        end.record()
        torch.cuda.synchronize()
        same(f"{what} S", s, want)
        same(f"{what} claimed sum", claimed, want_claimed)
        return start.elapsed_time(end)

    def composition(segments, elements, alpha, log_blowup):
        args = (segments, elements, alpha, log_blowup)
        outs = real_comp(*args)
        key = f"{prove} composition launch"
        plain_ms = check_composition(key, args, outs)
        spec = [(seg.log_size, seg.is_first.shape[0], [m.component for m in seg.members],
                 seg.rotation is not None) for seg in segments]
        shapes[key] = ("composition", spec, log_blowup)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_comp(*args)
        host_ms = (time.perf_counter() - t0) * 1e3
        times[key] = {"rows": sum(m for _, m, _, _ in spec), "launches": 1,
                      "segments": [{"log_size": n, "rows": m, "components": [c.name for c in cs]}
                                   for n, m, cs, _ in spec],
                      "ms": _time_ms(lambda: real_comp(*args), reps=5, queued=True),
                      "host_ms": host_ms, "plain_ms": plain_ms,
                      **_composition_bound(spec, log_blowup, per_mul, dispatch_per_s)}
        return outs

    def pair(what, component, main, els, timed):
        """The mesh's pair on the interaction's inputs: the logup kernel
        (is_first as a column) and the coset scan of its row sums, each
        against its plain version; with `timed`, both timed (their keys'
        lines) and the pair's ms returned."""
        m = 1 << component.log_size
        isf = torch.zeros(m, dtype=torch.int32, device=main[component.columns[0]].device)
        isf[0] = 1
        largs = (component, main, isf, els)
        q, total = real_logup(*largs)
        plain_l = check_logup(f"{what} logup", largs, q, total, sample=not timed)
        s, claimed = real_scan(total)
        plain_s = check_scan(f"{what} scan", total, s, claimed)
        if prove == "fib19_io" and not timed and "edge" not in what:
            scan_chunks_check(what, total)
        if not timed:
            return None
        name = f"{component.name} 2^{component.log_size}"
        gathered = total[:, fft.coset_order_permutation(component.log_size, total.device)]
        logup_ms = _time_ms(lambda: real_logup(*largs), reps=5, queued=True)
        scan_ms = _time_ms(lambda: real_scan(total), reps=5, queued=True)
        times[f"{prove} logup {name}"] = {"rows": m, "ms": logup_ms, "plain_ms": plain_l,
                                          **_constraint_bound(component, "logup", m, per_mul,
                                                              dispatch_per_s)}
        # the coset mode: no prove path runs it (the interaction kernel
        # computes the prefix sum on one device)
        times[f"{prove} coset_scan {name}"] = {
            "rows": m, "ms": scan_ms, "plain_ms": plain_s, "off_path": True,
            "library_ms": _time_ms(lambda: torch.cumsum(gathered, dim=1, dtype=torch.int64),
                                   reps=5),
            **_constraint_bound(component, "scan", m, per_mul, dispatch_per_s)}
        for shards in MESH_SHARDS:
            if m >= 2 * shards:
                linear_scan_timed(name, component, gathered, shards)
        return logup_ms + scan_ms

    def linear_scan_timed(name, component, lin, shards):
        """The scan as the mesh runs it: the second of `shards` linear
        chunks of the rows' sums, its carry the first chunk's sum, against
        the plain prefix sum; timed beside its bound and torch.cumsum of
        the chunk."""
        c = lin.shape[1] // shards
        chunk = lin[:, c:2 * c].contiguous()
        carry = (lin[:, :c].to(torch.int64).sum(1) % P).to(torch.int32)
        s, claimed = real_scan(chunk, False, carry)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want, want_claimed = framework.prefix_sum_plain(lin[:, :2 * c])
        end.record()
        torch.cuda.synchronize()
        same(f"{prove} linear scan {name} chunk 2 of {shards} S", s, want[:, c:])
        same(f"{prove} linear scan {name} chunk 2 of {shards} claimed sum", claimed,
             want_claimed)
        times[f"{prove} scan {name} chunk 2 of {shards}"] = {
            "rows": c, "ms": _time_ms(lambda: real_scan(chunk, False, carry), reps=5,
                                      queued=True),
            "plain_ms": start.elapsed_time(end), "mode": "linear, with a carry",
            "library_ms": _time_ms(lambda: torch.cumsum(chunk, dim=1, dtype=torch.int64),
                                   reps=5),
            **_constraint_bound(component, "scan", c, per_mul, dispatch_per_s)}

    def interaction(component, main_cols, elements):
        args = (component, main_cols, elements)
        got = real_inter(*args)
        key = f"{prove} interaction {component.name} 2^{component.log_size}"
        plain_ms = check_interaction(key, args, got)
        m = 1 << component.log_size
        shapes[key] = ("interaction", component, m, 0, 0)
        geo = K.geometry(type(component), component.log_size, got[1].device)
        times[key] = {"rows": m, "ms": _time_ms(lambda: real_inter(*args), reps=5, queued=True),
                      "plain_ms": plain_ms, "library_ms": None,
                      "pair_ms": pair(key, component, main_cols, elements, True),
                      "tiles": geo[3], "tile_rows": geo[2], "on_chip": bool(geo[5]),
                      **_constraint_bound(component, "interaction", m, per_mul, dispatch_per_s),
                      "per_row_inverse_bound_ms": _constraint_bound(
                          component, "interaction", m, per_mul, dispatch_per_s,
                          batch=0)["bound_ms"]}
        return got

    # the proves' own inputs, then random and edge inputs at their shapes
    inputs_checked = 0
    with open(fib_path) as f:
        fib = compile_program(f.read())
    with open(big_path) as f:
        big = compile_program(f.read())
    proves = (("fib19_io", fib, FIB_INPUT, None, REFERENCE_SHA256["fib19_io"]),
              ("big22", big, b"", None, RECORDED_SHA256["big22"]),
              ("fib19_io_in19_production", fib, FIB_INPUT, PRODUCTION,
               RECORDED_SHA256["fib19_io_in19_production"]))
    for prove, code, inp, config, sha in proves:
        _clear_prover_caches()
        shapes.clear()
        machine = create_test_machine(code, inp)
        machine.execute()
        with mock.patch.object(K, "composition", composition), \
                mock.patch.object(K, "interaction", interaction):
            proof = air.prove_brainfuck(machine, config, device="cuda")
        if proof_sha256(proof) != sha:
            raise AssertionError(f"{prove} proof under the constraint check: sha256 "
                                 f"{proof_sha256(proof)} != {sha}")
        air.verify_brainfuck(proof, device="cuda")
        del proof
        rng = np.random.default_rng(len(times))
        gen = torch.Generator(device="cuda")
        dev = torch.device("cuda", torch.cuda.current_device())
        for key, shape in list(shapes.items()):
            family = shape[0]
            if family == "composition":
                _, spec, blow = shape
            else:
                _, component, m, _, _ = shape
            for edge in (False, True):
                gen.manual_seed(int(rng.integers(1 << 62)))
                if family != "composition":
                    main = dict(zip(component.columns, _rows_like(gen, len(component.columns), m,
                                                                  dev, edge)))
                els = _elements(rng)
                what = f"{key} on {'edge' if edge else 'random'} inputs"
                if family == "interaction":
                    if edge:
                        els = zero_den_elements(component, main, els, [0, 1, m - 2, m // 2 + 1])
                        # the scan's rows' sums themselves edge values, in
                        # both modes
                        total = torch.stack(_rows_like(gen, 4, m, dev, True))
                        check_scan(f"{what} edge sums", total, *real_scan(total))
                        scan_chunks_check(f"{what} edge sums", total)
                    iargs = (component, main, els)
                    check_interaction(what, iargs, real_inter(*iargs))
                    pair(what, component, main, els, False)
                else:
                    cargs = (_random_segments(gen, spec, blow, dev, edge, rng), els, _felt(rng),
                             blow)
                    outs = real_comp(*cargs)
                    check_composition(what, cargs, outs, sample=True)
                    if prove == "fib19_io" and not edge:
                        chunks_check(what, cargs, outs)
                inputs_checked += 1
        shapes.clear()
    _clear_prover_caches()
    out = {"shapes": len(times), "comparisons": len(times) + inputs_checked, "tolerance": 0,
           "max_abs_err": max_err, "chunk_log": CONSTRAINT_CHUNK_LOG,
           "sample_log": CONSTRAINT_SAMPLE_LOG, "chunks": CONSTRAINT_CHUNKS, "times": times}
    _line("constraints", out)
    return out


def scan_chunks_check(what: str, total: torch.Tensor) -> None:
    """The rows of `total` in coset linear order as CONSTRAINT_CHUNKS
    linear scans (the mesh's form), each launch's carry the claimed sum of
    the one before, against the plain prefix sum of the whole in linear
    order: every chunk's S and the last claimed sum."""
    lin = total[:, fft.coset_order_permutation(total.shape[1].bit_length() - 1, total.device)]
    want, want_claimed = framework.prefix_sum_plain(lin)
    c = lin.shape[1] // CONSTRAINT_CHUNKS
    carry = None
    for i in range(CONSTRAINT_CHUNKS):
        sl = slice(i * c, (i + 1) * c)
        s, carry = constraint_kernels.KERNELS.scan(lin[:, sl].contiguous(), False, carry)
        if not torch.equal(s, want[:, sl]):
            raise AssertionError(f"{what}: linear scan chunk {i} of {CONSTRAINT_CHUNKS} != plain")
    if not torch.equal(carry, want_claimed):
        raise AssertionError(f"{what}: the chained linear scans' claimed sum != plain")


def _composition_bound(spec: list, log_blowup: int, per_mul: float,
                       dispatch_per_s: float) -> dict:
    """A composition launch's bounds (constraint_kernels.composition_work
    over its segments, (log_size, rows, components, rotation) each): bytes
    at the memory rate; its products at per_mul instructions and its adds
    at 2 at the dispatch rate."""
    nbytes, products, adds = constraint_kernels.composition_work(spec, log_blowup)
    return {"products": products, "adds": adds,
            **bound(nbytes, products * per_mul + 2 * adds, dispatch_per_s)}


def _random_segments(gen, spec: list, blow: int, dev, edge: bool, rng) -> list:
    """Composition segments of the shapes `spec` ((log_size, rows,
    components, rotation) each) on random or edge rows: each component's
    columns and interaction rows, a claimed sum, the alpha offsets of the
    claim's order; is_first a segment, S(p - g) through the rotation
    index."""
    offsets, off = {}, 0
    for cls in COMPONENT_CLASSES:
        offsets[cls.name] = off
        off += len(framework.constraint_program(cls).constraints)
    segments = []
    for n, m, components, _ in spec:
        members = []
        for comp in components:
            main = dict(zip(comp.columns, _rows_like(gen, len(comp.columns), m, dev, edge)))
            inter = _rows_like(gen, 4 * (comp.relation_count() + 1), m, dev, edge)
            members.append(framework.CompositionMember(comp, main, inter, inter[-4:], _felt(rng),
                                                       offsets[comp.name]))
        segments.append(framework.CompositionSegment(n, members,
                                                     _rows_like(gen, 1, m, dev, edge)[0],
                                                     fft.rotation_index(n, blow, dev)))
    return segments


def chunks_check(what: str, args: tuple, whole: list) -> None:
    """The composition launch of `args` (S(p - g) through the rotation
    index) as one launch of CONSTRAINT_CHUNKS chunks a segment at their
    offsets, S(p - g) once given as rows (the mesh's form) and once
    through the rotation index, each equal to the whole launch's rows."""
    segments, els, alpha, blow = args
    chunks, where = [], []
    for k, seg in enumerate(segments):
        c = seg.is_first.shape[0] // CONSTRAINT_CHUNKS
        for i in range(CONSTRAINT_CHUNKS):
            sl = slice(i * c, (i + 1) * c)
            for given in (True, False):
                members = []
                for mem in seg.members:
                    s_rows = mem.s_rows
                    if given:
                        s_prev = torch.stack(s_rows)[:, seg.rotation[sl].to(torch.int64)]
                        s_rows = list(s_prev)
                    members.append(framework.CompositionMember(
                        mem.component, {n: v[sl] for n, v in mem.main_cols.items()},
                        [r[sl] for r in mem.inter_rows], s_rows, mem.claimed_sum,
                        mem.alpha_offset))
                chunks.append(framework.CompositionSegment(
                    seg.log_size, members, seg.is_first[sl], None if given else seg.rotation,
                    i * c))
                where.append((k, sl, given))
    for got, (k, sl, given) in zip(
            constraint_kernels.KERNELS.composition(chunks, els, alpha, blow), where):
        if not torch.equal(got, whole[k][:, sl]):
            raise AssertionError(f"{what}: segment 2^{segments[k].log_size} chunk at {sl.start} "
                                 f"({'rows' if given else 'rotation'}) != whole")


def phase_production(fib_path: str) -> dict:
    """PRODUCTION (PcsConfig(log_blowup=4, n_queries=30, pow_bits=16)) on
    the card, counts at 0 first: the fused extend at fib19_io's production
    shapes against its plain version; the small program's proof against
    the JAX package's sha256, verified; fib19_io at its 2^18-table input
    (bench.FIB_2_18_INPUT) proved cold and warm (one sha256), verified, the
    grind launched once a prove and the tree kernel once a commit. Returns
    the launches of its proves."""
    fft_check = phase_production_fft(production_extends(fib_path))
    _reset_counts()
    machine = create_test_machine(compile_program(SMALL_CODE), SMALL_INPUT.encode())
    machine.execute()
    before = _counts()
    with _counting_commits() as counted:
        proof = air.prove_brainfuck(machine, PRODUCTION, device="cuda")
    torch.cuda.synchronize()
    launched = _check_launches(before, "small production", grind=True)
    _trees_per_commit(launched, counted["commits"], 0, "small production")
    sha = proof_sha256(proof)
    if sha != REFERENCE_SHA256["small_production"]:
        raise AssertionError(f"small production proof sha256 {sha} != JAX reference")
    air.verify_brainfuck(proof, device="cuda")
    _line("production", {"program": "small", "pcs_config": PRODUCTION.to_json(), "sha256": sha,
                         "matches_jax": True, "verified": True,
                         "blake2s_launches": {k: launched[k] for k in blake2s_kernels.ENTRIES}})
    for inp in (bench.FIB_2_18_INPUT, FIB_INPUT):
        phase_program("fib19_io", fib_path, inp, runs=2, expect_sha=None, config=PRODUCTION,
                      tag="production",
                      recorded="fib19_io_in19_production" if inp == FIB_INPUT else None)
    launched = _require_here(_counts(), "the production path", grind=True)
    _clear_prover_caches()
    return {"launches": launched, "max_abs_err": fft_check["max_abs_err"]}


class _PeakTimer(air.PhaseTimer):
    """A PhaseTimer that also keeps each phase's peak allocated bytes and
    its peak requested bytes (the tensors' own sizes, before the allocator
    rounds them to its blocks); the peak statistics are reset at every
    mark."""

    def __init__(self, device):
        super().__init__(device)
        self.peaks: dict = {}
        self.requested: dict = {}
        torch.cuda.reset_peak_memory_stats(self.device)

    def mark(self, name: str) -> None:
        super().mark(name)
        self.peaks[name] = torch.cuda.max_memory_allocated(self.device)
        self.requested[name] = torch.cuda.memory_stats(self.device).get(
            "requested_bytes.all.peak")
        torch.cuda.reset_peak_memory_stats(self.device)


def _blocks_at_peak(trace: list) -> tuple:
    """Replay the allocator's trace of one device: (the most bytes live at
    once, the blocks live then, the out-of-memory request if there was one).
    A block allocated before the recording began is not in the trace."""
    live, total, peak, at_peak, oom = {}, 0, 0, {}, None
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif ev["action"] == "free_completed":
            gone = live.pop(ev["addr"], None)
            total -= gone["size"] if gone else 0
        elif ev["action"] == "oom":
            oom = ev
            if total >= peak:
                peak, at_peak = total, dict(live)
    return peak, list(at_peak.values()), oom


def _frames(ev: dict, limit: int = 5) -> list:
    """The block's allocation stack inside this repository, innermost first."""
    out = []
    for fr in ev.get("frames", []):
        name = fr.get("filename", "")
        if "stwo_brainfuck_tpu_torch" in name or name.endswith("chip_smoke.py"):
            out.append(f"{os.path.relpath(name, ROOT)}:{fr.get('line')} {fr.get('name')}")
        if len(out) == limit:
            break
    return out


def phase_production_memory(fib_path: str) -> dict:
    """One cold PRODUCTION prove of fib19_io at input 19 (every prover cache
    cleared first) under torch.cuda.memory._record_memory_history: the peak
    allocated bytes, each phase's peak and the phase at the peak
    (air.PhaseTimer), and the MEMORY_TOP largest blocks live at the peak
    with their sizes and allocation stacks (the allocator's trace
    replayed). Raises after its line if the prove ran out of memory."""
    _clear_prover_caches()
    with open(fib_path) as f:
        machine = create_test_machine(compile_program(f.read()), FIB_INPUT)
    machine.execute()
    timer = _PeakTimer("cuda")
    torch.cuda.memory._record_memory_history(enabled="all", context="alloc", stacks="python",
                                             max_entries=MEMORY_EVENTS)
    error = None
    t0 = time.perf_counter()
    try:
        proof = air.prove_brainfuck(machine, PRODUCTION, device="cuda", timer=timer)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as exc:
        proof, error = None, exc
    prove_s = time.perf_counter() - t0
    at_error = timer.current()
    if error is not None:
        timer.peaks[at_error] = torch.cuda.max_memory_allocated()
    snapshot = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    dev = torch.cuda.current_device()
    replay_peak, blocks, oom = _blocks_at_peak(snapshot["device_traces"][dev])
    blocks.sort(key=lambda ev: -ev["size"])
    phase = max(timer.peaks, key=timer.peaks.get)
    out = {"program": "fib19_io", "input": list(FIB_INPUT), "pcs_config": PRODUCTION.to_json(),
           "prove_s": prove_s, "phases_s": timer.seconds,
           "peak_device_bytes": max(timer.peaks.values()), "phase_at_peak": phase,
           "peaks_by_phase": timer.peaks, "requested_peaks_by_phase": timer.requested,
           "trace_events": len(snapshot["device_traces"][dev]),
           "trace_peak_bytes": replay_peak,
           "largest_at_peak": [{"bytes": ev["size"], "stack": _frames(ev)}
                               for ev in blocks[:MEMORY_TOP]]}
    if error is not None:
        out.update({"out_of_memory": True, "phase": at_error, "error": str(error)[:300],
                    "oom_request_bytes": oom["size"] if oom else None})
    else:
        air.verify_brainfuck(proof, device="cuda")
        out.update({"sha256": proof_sha256(proof), "verified": True})
    _line("production_memory", out)
    del proof, snapshot, blocks
    error = None
    _clear_prover_caches()
    if "out_of_memory" in out:
        raise AssertionError(f"the production prove of fib19_io ran out of memory in {at_error}")
    return out


def phase_bench() -> dict:
    """`python -m stwo_brainfuck_tpu_torch.bench` in a subprocess with
    BENCH_BIG=0 (big22 is proved above), sent SIGTERM once the headline and
    the small row are done: its one final line (printed on an earlier line
    here as `bench`) must carry the fib19_io headline's JAX sha256, verified,
    with three warm runs, and list every suite row (the production rows
    "not reached: signal 15"); the process exits 0 and leaves no child.
    Returns the headline's kernel launches (from the bench's suite file)."""
    def bench_children() -> list:
        found = []
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read().split(b"\0")
            except OSError:
                continue
            if b"stwo_brainfuck_tpu_torch.bench" in cmd and b"--one" in cmd:
                found.append(int(pid))
        return found

    with tempfile.TemporaryDirectory() as tmp:
        suite_path = os.path.join(tmp, "suite.json")
        env = dict(os.environ, BENCH_BIG="0", BENCH_SUITE_PATH=suite_path)
        proc = subprocess.Popen([sys.executable, "-m", "stwo_brainfuck_tpu_torch.bench"],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        watchdog = threading.Timer(DIST_TIMEOUT_S, proc.kill)
        watchdog.start()
        seen = []
        try:
            for line in proc.stderr:
                seen.append(line)
                if line.startswith("# small:"):
                    proc.send_signal(signal.SIGTERM)
                    break
            out, err = proc.communicate(timeout=DIST_TIMEOUT_S)
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err = "".join(seen) + err
        lines = [ln for ln in out.splitlines() if ln.strip()]
        if proc.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"bench exited {proc.returncode} with {len(lines)} stdout "
                                 f"lines:\n{out[-2000:]}\n{err[-4000:]}")
        final = json.loads(lines[0])
        with open(suite_path) as f:
            rows = json.load(f)["rows"]
    head = rows["fib19_io"]
    want_rows = {"big22": {"skipped": "BENCH_BIG=0"},
                 "fib19_io_production": {"skipped": "not reached: signal 15"},
                 "fib19_io_in16_production": {"skipped": "not reached: signal 15"}}
    problems = []
    if len(lines[0]) >= 2000:
        problems.append(f"final line of {len(lines[0])} characters")
    if final["sha256"] != REFERENCE_SHA256["fib19_io"] or final["verified"] is not True:
        problems.append("headline sha256 or verified")
    if len(final["warm_runs_s"]) < 3 or not final["partial"].startswith("signal 15"):
        problems.append("warm runs or partial")
    if set(final["suite"]) != set(bench.SUITE) or final["suite"]["small"].get("ok") is not True:
        problems.append(f"suite rows {sorted(final['suite'])}")
    problems += [f"row {k}: {rows[k]}" for k, v in want_rows.items() if rows[k] != v]
    if bench_children():
        problems.append(f"child processes left: {bench_children()}")
    if problems:
        raise AssertionError(f"bench final line: {problems}:\n{lines[0]}")
    _line("bench", final)
    launched = head["kernel_launches"]
    plain = head["plain_cuda_calls"]
    _require(launched, plain["fft"], plain["blake2s"], "the bench's headline",
             plain_quotients=plain["quotients"], plain_constraints=plain["constraints"],
             plain_oods_fri=plain["oods"] + plain["fri"], plain_tables=plain["tables"])
    return launched


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_counts(rank: int, launches: dict, plain_fft: int, plain_blake: int,
                 plain_quotients: int, plain_constraints: int, plain_oods_fri: int,
                 plain_tables: int, grind: bool = False) -> dict:
    """A process's kernel launches and plain FFT, Blake2s, quotient,
    constraint and table calls over one prove: the FFT, tree, quotient,
    constraint and table kernels (and the grind where pow_bits > 13)
    launched, the table kernel once, no plain call."""
    _require(launches, plain_fft, plain_blake, f"process {rank}", grind, plain_quotients,
             plain_constraints, plain_oods_fri, plain_tables)
    if launches["tables"] != 1:
        raise AssertionError(f"process {rank}: {launches['tables']} table launches a prove")
    return {"fft_launches": launches["fft"],
            "blake2s_launches": {k: launches[k] for k in blake2s_kernels.ENTRIES},
            "quotient_launches": launches["quotients"],
            "constraint_launches": _constraint_launches(launches),
            "oods_launches": launches["oods"], "fold_launches": launches["fri_fold"],
            "plain_fft_cuda_calls": plain_fft, "plain_blake2s_cuda_calls": plain_blake,
            "plain_quotient_cuda_calls": plain_quotients,
            "plain_constraint_cuda_calls": plain_constraints,
            "plain_oods_fold_cuda_calls": plain_oods_fri, "table_launches": launches["tables"],
            "plain_table_calls": plain_tables}


_CLI_COUNTS = re.compile(r"Circle FFT kernel launches: (\d+); plain FFT calls on CUDA "
                         r"tensors: (\d+)")
_CLI_HASHES = re.compile(r"Blake2s kernel launches: tree (\d+), level (\d+), grind (\d+); "
                         r"plain Blake2s calls on CUDA tensors: (\d+)")
_CLI_QUOTIENTS = re.compile(r"Quotient kernel launches: (\d+); plain quotient calls on CUDA "
                            r"tensors: (\d+)")
_CLI_CONSTRAINTS = re.compile(r"constraint kernel launches: composition (\d+), interaction "
                              r"(\d+), logup (\d+), scan (\d+); plain constraint calls on CUDA "
                              r"tensors: (\d+)")
_CLI_OODS_FRI = re.compile(r"OODS kernel launches: (\d+), fold kernel launches: (\d+); plain "
                           r"OODS and fold calls on CUDA tensors: (\d+)")
_CLI_TABLES = re.compile(r"Table kernel launches: (\d+); host table passes and plain table "
                         r"builds on CUDA: (\d+)")


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
        quots = [q for _, err in outs for q in _CLI_QUOTIENTS.findall(err)]
        cons = [c for _, err in outs for c in _CLI_CONSTRAINTS.findall(err)]
        folds = [c for _, err in outs for c in _CLI_OODS_FRI.findall(err)]
        tabs = [c for _, err in outs for c in _CLI_TABLES.findall(err)]
        times = [float(t) for _, err in outs for t in re.findall(r"proof time: ([0-9.]+) s", err)]
        written = sum(err.count("Proof written") for _, err in outs)
        if (len(counts) != world or len(hashes) != world or len(quots) != world
                or len(cons) != world or len(folds) != world or len(tabs) != world
                or len(times) != world or written != 1):
            raise AssertionError(f"distributed CLI ({world} x {backend}): {len(counts)} counts, "
                                 f"{len(hashes)} hash counts, {len(quots)} quotient counts, "
                                 f"{len(cons)} constraint counts, {len(folds)} OODS and fold "
                                 f"counts, {len(tabs)} table counts, {len(times)} times and "
                                 f"{written} proofs written in the logs")
        ranks = [{"prove_s": t, **_rank_counts(
                     i, {"fft": int(c[0]), **dict(zip(("tree", "level", "grind"), map(int, h[:3]))),
                         "quotients": int(q[0]), "composition": int(k[0]),
                         "interaction": int(k[1]), "logup": int(k[2]), "scan": int(k[3]),
                         "oods": int(o[0]), "fri_fold": int(o[1]), "tables": int(b[0])},
                     int(c[1]), int(h[3]), int(q[1]), int(k[4]), int(o[2]), int(b[1]),
                     grind=bool(pow_bits and pow_bits > 13))}
                 for i, (c, h, q, k, o, b, t) in enumerate(zip(counts, hashes, quots, cons, folds,
                                                               tabs, times))]
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
        total = _add_counts(total, {"fft": r["fft_launches"], **r["blake2s_launches"],
                                    "quotients": r["quotient_launches"],
                                    **r["constraint_launches"], "oods": r["oods_launches"],
                                    "fri_fold": r["fold_launches"],
                                    "tables": r["table_launches"]})
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
                with (tracing.record(run) as rec, _counting_commits() as counted,
                      _counting_sums() as sums):
                    timer = _PhaseCalls(mesh.home)
                    t0 = time.perf_counter()
                    proof = air.prove_brainfuck(machine, timer=timer, mesh=mesh)
                    torch.cuda.synchronize(mesh.home)
                res = {"rank": rank, "run": run, "device": str(mesh.home),
                       "commits": counted["commits"],
                       "steps": len(machine.trace()), "prove_s": time.perf_counter() - t0,
                       "phases_s": timer.seconds, "decommit_calls": timer.calls["decommit"],
                       "peak_device_bytes": torch.cuda.max_memory_allocated(mesh.home),
                       "launches": _counts(),
                       "plain_fft_cuda_calls": fft.PLAIN_CUDA_CALLS,
                       "plain_blake2s_cuda_calls": blake2s.PLAIN_CUDA_CALLS,
                       "plain_quotient_cuda_calls": quotients.PLAIN_CUDA_CALLS,
                       "plain_constraint_cuda_calls": framework.PLAIN_CUDA_CALLS,
                       "plain_oods_fold_cuda_calls": poly.PLAIN_CUDA_CALLS + fri.PLAIN_CUDA_CALLS,
                       "plain_table_calls": _plain_tables(),
                       "oods_pulls": timer.calls["oods"].get("oods_pulls", 0),
                       "fri_layers": len(proof["fri"]["layer_roots"]),
                       "m31_launches": sum(m31_kernels.KERNELS.launches.values()),
                       "plain_m31_cuda_calls": m31_kernels.PLAIN_CUDA_CALLS,
                       "cross_chunks": sum(1 for sp in rec.spans if sp.name == "fft.cross"),
                       "sums": sums.call_count,
                       "plain_mesh_cuda_calls": mesh_kernels.PLAIN_CUDA_CALLS}
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
                                  r["plain_blake2s_cuda_calls"], r["plain_quotient_cuda_calls"],
                                  r["plain_constraint_cuda_calls"],
                                  r["plain_oods_fold_cuda_calls"], r["plain_table_calls"]))
            _oods_fri_per_prove(r["launches"], r["fri_layers"], 1, r["oods_pulls"],
                                f"process {r['rank']}")
            r.update(_trees_per_commit(r["launches"], r["commits"], 1, f"process {r['rank']}"))
            r["decommit"] = _decommit_phase(r["phases_s"]["decommit"], r["decommit_calls"],
                                            f"process {r['rank']}", mesh=True)
            if r["m31_launches"] or r["plain_m31_cuda_calls"]:
                raise AssertionError(f"process {r['rank']}: an M31 kernel or plain M31 op ran")
            if r["plain_mesh_cuda_calls"]:
                raise AssertionError(f"process {r['rank']}: a plain mesh stage ran on a CUDA "
                                     f"tensor {r['plain_mesh_cuda_calls']} times")
            want = r["cross_chunks"] + r["sums"]
            if r["launches"]["mesh_stages"] != want or not want:
                raise AssertionError(f"process {r['rank']}: {r['launches']['mesh_stages']} "
                                     f"mesh-stage launches, not {want}")
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
            "processes": [{k: r[k] for k in ("rank", "device", "prove_s", "phases_s", "decommit",
                                         "peak_device_bytes", "fft_launches",
                                         "blake2s_launches", "quotient_launches",
                                         "constraint_launches", "oods_launches",
                                         "fold_launches", "table_launches", "commits",
                                         "cross_chunks", "sums",
                                         "tree_launches_per_commit", "plain_fft_cuda_calls",
                                         "plain_blake2s_cuda_calls", "plain_quotient_cuda_calls",
                                         "plain_constraint_cuda_calls")} for r in ranks]})
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


def _meta_fields(dm, hm, name: str) -> None:
    """The device meta pass's fields against the host pass's, bit for bit."""
    if list(dm.claim.items()) != list(hm.claim.items()) or dm.k != hm.k:
        raise AssertionError(f"{name}: device meta claim {dm.claim} / {dm.k} != host {hm.claim} "
                             f"/ {hm.k}")
    for field in ("order_mem", "counts_mem", "order_ins", "prog_cols", "eoe_cols"):
        got = getattr(dm, field).cpu().numpy().astype(np.int64)
        want = getattr(hm, field).astype(np.int64)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{name}: device meta {field} != build_meta's")
    sel = dm.sel
    for key, want in hm.sel.items():
        if not np.array_equal(sel[key].cpu().numpy(), want):
            raise AssertionError(f"{name}: device meta sel[{key}] != build_meta's")


def phase_tables(programs) -> dict:
    """The table build on the card (device_build.build_tables' two steps):
    the meta pass (device_meta) against the host pass (build_meta) field by
    field; the table kernel's 13 matrices against its plain version
    (table_kernels.tables_plain) and the host builders, bit for bit. Times,
    warm (the best of TABLE_REPS): the meta pass less its pull (host and
    device, to the synchronization the pull begins with), the pull, the
    kernel (device time: 10 launches on one staged launch table, queued
    behind a sleep) beside its bytes bound, the plain build and build_meta;
    the whole build_tables call."""
    out = {}
    real_pull = tracing.pull
    for name, code, inp in programs:
        m = create_test_machine(compile_program(code), inp)
        m.execute()
        trace, program = m.trace(), m.program()
        t0 = time.perf_counter()
        hm = device_build.build_meta(trace, program)
        build_meta_s = time.perf_counter() - t0
        host = tables.all_tables(trace, program)
        meta_s, pull_s, whole_s = [], [], []

        def timed_pull(site, vec):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = real_pull(site, vec)
            pull_s.append(time.perf_counter() - t)
            return got

        for _ in range(TABLE_REPS):
            torch.cuda.synchronize()
            with mock.patch.object(tracing, "pull", timed_pull):
                t0 = time.perf_counter()
                dm = device_build.device_meta(trace, program, "cuda")
                meta_s.append(time.perf_counter() - t0 - pull_s[-1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            claim, mats = device_build.build_tables(trace, program, "cuda")
            torch.cuda.synchronize()
            whole_s.append(time.perf_counter() - t0)
            del mats
        _meta_fields(dm, hm, name)
        if claim != dm.claim:
            raise AssertionError(f"{name}: build_tables' claim != device_meta's")
        launches = table_kernels.KERNEL.launches
        mats = table_kernels.KERNEL.build(dm)
        if table_kernels.KERNEL.launches != launches + 1:
            raise AssertionError(f"{name}: the table kernel launched "
                                 f"{table_kernels.KERNEL.launches - launches} times, not once")
        plain = table_kernels.tables_plain(dm.rows.T, dm, "cuda")
        torch.cuda.synchronize()
        elements = 0
        for cls in COMPONENT_CLASSES:
            comp = cls(dm.claim[cls.name])
            want = np.stack([host[comp.name][col] for col in comp.columns]).view(np.int32)
            got = mats[comp.name].cpu().numpy()
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"{name}: table kernel {comp.name} != host builder")
            if not torch.equal(mats[comp.name], plain[comp.name]):
                raise AssertionError(f"{name}: table kernel {comp.name} != its plain version")
            elements += got.size
        del mats, plain
        # the kernel alone: one launch table staged once, its outputs reused
        words, _ = table_kernels.KERNEL.prepare(dm)
        table = torch.as_tensor(words.view(np.int32), device="cuda")
        ms = _time_ms(lambda: table_kernels.KERNEL.enqueue(table, int(words[11])), reps=10,
                      queued=True)
        del table, _
        plain_ms = _time_ms(lambda: table_kernels.tables_plain(dm.rows.T, dm, "cuda"), reps=3)
        nbytes = table_kernels.bound_bytes(dm)
        out[name] = {"steps": len(trace), "max_log": max(dm.claim.values()),
                     "meta_s": min(meta_s), "pull_s": min(pull_s), "build_tables_s": min(whole_s),
                     "runs_s": {"meta": meta_s, "pull": pull_s, "build_tables": whole_s},
                     "build_meta_s": build_meta_s, "ms": ms, "plain_ms": plain_ms,
                     "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "elements": elements, "bit_identical": True,
                     "max_abs_err": 0}
        del dm, host
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
    if argv not in ([], ["distributed"], ["production_memory"], ["mesh"]):
        print(f"usage: {sys.argv[0]} [distributed | production_memory | mesh]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _smi("name,power.limit")
    max_mhz, sm_mhz = (float(v.split()[0]) for v in _smi("clocks.max.sm,clocks.sm").split(","))
    libs = (circle_fft.KERNEL.lib, m31_kernels.KERNELS.lib, blake2s_kernels.KERNELS.lib,
            quotient_kernels.KERNEL.lib, constraint_kernels.KERNELS.lib,
            constraint_kernels.KERNELS.scan_lib, oods_kernels.KERNEL.lib, fri_kernels.KERNEL.lib,
            table_kernels.KERNEL.lib, mesh_kernels.KERNEL.lib)
    nvcc.build_all(libs)
    for lib in libs:
        if lib.build_log.strip():
            print(lib.build_log.strip(), file=sys.stderr)
    if argv == ["production_memory"]:
        # the production memory reading alone
        phase_production_memory(os.path.join(ROOT, "programs", "fib19_io.bf"))
        print(card)
        return 0
    if argv == ["mesh"]:
        # the mesh-stage kernel alone, then the paths that launch it: a
        # fib19_io prove on four shards of the card and in two processes
        # sharing it, counts at 0 first
        stages = phase_mesh_stages()
        _reset_counts()
        phase_program("fib19_io", os.path.join(ROOT, "programs", "fib19_io.bf"), FIB_INPUT,
                      runs=2, expect_sha=REFERENCE_SHA256["fib19_io"], n_shards=4)
        sharded = _require_here(_counts(), "the mesh prover")
        _clear_prover_caches()
        distributed = _distributed_group(2, "gloo", "cuda:0", runs=1)
        print(card)
        print(json.dumps({"mesh_stages": stages["times"],
                          "launches": {"sharded_prover": sharded["mesh_stages"],
                                       "distributed_prover": distributed["mesh_stages"]}}))
        return 0
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
    table_times = phase_tables([("small", SMALL_CODE, SMALL_INPUT.encode()),
                                ("fib19_io", fib_code, FIB_INPUT), ("big22", big_code, b"")])
    blake = phase_blake2s(sass["per_compress"], dispatch_per_s, fib_code, SMALL_CODE)
    quot = phase_quotients(os.path.join(ROOT, "programs", "fib19_io.bf"), sass["per_mul"],
                           dispatch_per_s)
    cons = phase_constraints(os.path.join(ROOT, "programs", "fib19_io.bf"),
                             os.path.join(ROOT, "programs", "big22.bf"), sass["per_mul"],
                             dispatch_per_s)
    oods_fri = phase_oods_fri(os.path.join(ROOT, "programs", "fib19_io.bf"),
                              os.path.join(ROOT, "programs", "big22.bf"), sass["per_mul"],
                              dispatch_per_s)

    # the mesh prover: its transforms checked, then its path with the
    # counts at 0
    sharded_fft = phase_sharded_fft()
    mesh_stages = phase_mesh_stages()
    _clear_prover_caches()
    _reset_counts()
    phase_small("sharded_small", ("--devices", "8"))
    phase_small("sharded_small_pow16", ("--devices", "8", "--pow-bits", "16"), "small_pow16")
    for shards in MESH_SHARDS:
        phase_program("fib19_io", os.path.join(ROOT, "programs", "fib19_io.bf"), FIB_INPUT,
                      runs=2, expect_sha=REFERENCE_SHA256["fib19_io"], n_shards=shards)
    sharded = _require_here(_counts(), "the mesh prover", grind=True)
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
                  runs=2, expect_sha=None, fresh_verify=True, recorded="big22")
    # last: a profiled prove (its fib19_io caches are still warm)
    phase_split("fib19_io", fib_path, FIB_INPUT)
    main_path = _require_here(_counts(), "the main path", grind=True)
    fft_launches = main_path["fft"]
    _clear_prover_caches()
    # production parameters: the memory reading of one cold fib19_io prove,
    # then the path (counts at 0 inside), then the bench in a process
    phase_production_memory(fib_path)
    production = phase_production(fib_path)
    bench_path = phase_bench()

    headline = kern["times"]["evaluate (4, 2^24)"]
    kernels = [{
        "name": "circle_fft", "route": "cuda",
        "source": "stwo_brainfuck_tpu_torch/csrc/circle_fft.cu",
        "replaces": "stwo_brainfuck_tpu/ops/fft_pallas.py:364 (_make_pass1); "
                    "stwo_brainfuck_tpu/ops/fft_pallas.py:402 (_make_pass2)",
        "launches": fft_launches,
        "launches_by_path": {"prover": fft_launches, "sharded_prover": sharded["fft"],
                             "distributed_prover": distributed["fft"],
                             "production": production["launches"]["fft"],
                             "bench": bench_path["fft"]},
        "max_abs_err": max(kern["max_abs_err"], sharded_fft["max_abs_err"],
                           production["max_abs_err"]),
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
    headlines = {"tree": f"tree: FRI layer of 2^{FRI_LOG} leaves",
                 "level": f"level: FRI leaf (4, 2^{FRI_LOG})",
                 "grind": next(k for k in blake["times"] if k.startswith("grind"))}
    for entry in blake2s_kernels.ENTRIES:
        t = blake["times"][headlines[entry]]
        by_path = {"prover": main_path[entry], "sharded_prover": sharded[entry],
                   "distributed_prover": distributed[entry],
                   "production": production["launches"][entry], "bench": bench_path[entry]}
        if entry == "level":  # on no prove path: its own, hash_words
            by_path["hash_words"] = blake["hash_words_launches"]
        kernels.append({
            "name": f"blake2s_{entry}", "route": "cuda",
            "source": "stwo_brainfuck_tpu_torch/csrc/blake2s.cu",
            "replaces": BLAKE_REPLACES[entry], "shape": headlines[entry],
            "launches": by_path["hash_words" if entry == "level" else "prover"],
            "launches_by_path": by_path,
            "max_abs_err": blake["max_abs_err"][entry],
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "rate_bound_ms": t["rate_bound_ms"],
            **{k: t[k] for k in ("latency_floor_ms", "launch_ms") if k in t},
            "library_ms": None,
        })
    quot_times = quot["times"][max(quot["times"], key=lambda k: quot["times"][k]["positions"])]
    kernels.append({
        "name": "quotients", "route": "cuda",
        "source": "stwo_brainfuck_tpu_torch/csrc/quotients.cu",
        "replaces": "stwo_brainfuck_tpu/core/quotients.py:217 (_accumulate_all_jit, with :116 "
                    "_weighted_columns and :139 _point_group_quotient)",
        "shape": max(quot["times"], key=lambda k: quot["times"][k]["positions"]),
        "launches": main_path["quotients"],
        "launches_by_path": {"prover": main_path["quotients"],
                             "sharded_prover": sharded["quotients"],
                             "distributed_prover": distributed["quotients"],
                             "production": production["launches"]["quotients"],
                             "bench": bench_path["quotients"]},
        "max_abs_err": quot["max_abs_err"], "ms": quot_times["ms"],
        "plain_ms": quot_times["plain_ms"], "bound_ms": quot_times["bound_ms"],
        "bound_by": quot_times["bound_by"], "library_ms": None,
    })
    # each constraint kernel's own path: the one-device prover runs the
    # composition and interaction kernels; the logup kernel and the scan run
    # on the mesh's and the processes' shards
    for family, replaces, source, own in (
            ("composition", "stwo_brainfuck_tpu/framework/component.py:520 (_constraints_fn)",
             "constraints.cu", "prover"),
            ("interaction", "stwo_brainfuck_tpu/framework/component.py:372 "
                            "(_build_interaction_fn)", "constraints.cu", "prover"),
            ("logup", "stwo_brainfuck_tpu/framework/component.py:372 (_build_interaction_fn, "
                      "the fractions)", "constraints.cu", "sharded_prover"),
            ("scan", SCAN_REPLACES, "logup_scan.cu", "sharded_prover")):
        default = [k for k in cons["times"] if k.startswith(f"fib19_io {family} ")]
        head = max(default, key=lambda k: (cons["times"][k]["rows"], cons["times"][k]["bound_ms"]))
        t = cons["times"][head]
        by_path = {"prover": main_path[family], "sharded_prover": sharded[family],
                   "distributed_prover": distributed[family],
                   "production": production["launches"][family], "bench": bench_path[family]}
        kernels.append({
            "name": "logup_scan" if family == "scan" else f"constraints_{family}",
            "route": "cuda", "source": "stwo_brainfuck_tpu_torch/csrc/" + source,
            "replaces": replaces, "shape": head, "launches": by_path[own],
            "launches_path": own, "launches_by_path": by_path,
            "max_abs_err": cons["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"),
            **{k: t[k] for k in ("pair_ms", "mode", "host_ms") if k in t},
        })
        if family == "composition":  # the one launch of each prove
            kernels[-1]["launch_by_prove"] = {
                k.split(" composition")[0]: {f: v[f] for f in ("ms", "bound_ms", "bound_by",
                                                               "plain_ms", "host_ms", "rows")}
                for k, v in cons["times"].items() if k.endswith(" composition launch")}
    # the OODS and fold kernels: their largest launches (the production
    # prove's), launched on every path
    for name, source, replaces, kind in (("oods", "oods.cu", OODS_REPLACES, " oods: "),
                                         ("fri_fold", "fri_fold.cu", FOLD_REPLACES, " fold: ")):
        own = [k for k in oods_fri["times"] if kind in k]
        head = max(own, key=lambda k: oods_fri["times"][k]["bytes"])
        t = oods_fri["times"][head]
        by_path = {"prover": main_path[name], "sharded_prover": sharded[name],
                   "distributed_prover": distributed[name],
                   "production": production["launches"][name], "bench": bench_path[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": "stwo_brainfuck_tpu_torch/csrc/" + source,
            "replaces": replaces, "shape": head, "launches": main_path[name],
            "launches_by_path": by_path, "max_abs_err": oods_fri["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
        })
    # the table kernel: big22's build, the largest; one launch a prove on every path
    t = table_times["big22"]
    kernels.append({
        "name": "tables", "route": "cuda", "source": "stwo_brainfuck_tpu_torch/csrc/tables.cu",
        "replaces": TABLES_REPLACES, "shape": f"big22: 13 matrices, 2^{t['max_log']} largest",
        "launches": main_path["tables"],
        "launches_by_path": {"prover": main_path["tables"], "sharded_prover": sharded["tables"],
                             "distributed_prover": distributed["tables"],
                             "production": production["launches"]["tables"],
                             "bench": bench_path["tables"]},
        "max_abs_err": max(v["max_abs_err"] for v in table_times.values()), "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None,
    })
    # the mesh-stage kernel: the mesh's and the processes' paths only
    t = mesh_stages["times"]["evaluate_upper"]
    kernels.append({
        "name": "mesh_cross", "route": "cuda",
        "source": "stwo_brainfuck_tpu_torch/csrc/mesh_stages.cu",
        "replaces": "stwo_brainfuck_tpu/parallel/fft_sharded.py (the cross stages' elementwise "
                    "ops, fused by XLA) and the composition's sum of stwo_brainfuck_tpu/"
                    "parallel/prove.py",
        "shape": f"evaluate upper cross stage, 2^{MESH_STAGE_LOG} in place",
        "launches": sharded["mesh_stages"], "launches_path": "sharded_prover",
        "launches_by_path": {"prover": main_path["mesh_stages"],
                             "sharded_prover": sharded["mesh_stages"],
                             "distributed_prover": distributed["mesh_stages"],
                             "production": production["launches"]["mesh_stages"],
                             "bench": bench_path.get("mesh_stages", 0)},
        "max_abs_err": mesh_stages["max_abs_err"], "ms": t["kernel_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
    })
    if main_path["mesh_stages"] or production["launches"]["mesh_stages"]:
        raise AssertionError(f"the mesh-stage kernel ran on one device: main path {main_path}, "
                             f"production {production['launches']}")
    if main_path["logup"] or main_path["scan"] or not (sharded["logup"] and sharded["scan"]
                                                       and distributed["logup"]
                                                       and distributed["scan"]):
        raise AssertionError(f"logup and scan launches: main path {main_path}, mesh {sharded}, "
                             f"processes {distributed}")
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
