"""The port's benchmark: end-to-end proofs of Brainfuck executions on one card.

    python -m stwo_brainfuck_tpu_torch.bench                # on cuda:0
    python -m stwo_brainfuck_tpu_torch.bench --device cpu   # or BENCH_DEVICE=cpu

The counterpart of the repository's ``bench.py``, which proves with the JAX
package; this module imports torch and numpy only. Without a CUDA device
and without ``--device cpu`` it exits non-zero with one line on stderr: it
never carries on on the CPU.

Output contract (as ``bench.py``'s): the last stdout line is ONE compact
JSON object (under 2000 characters), printed exactly once, also on SIGTERM
and on SIGALRM (the budget), and never without a headline. Every row's
detail goes to stderr and to ``stwo_brainfuck_tpu_torch/build/
bench_suite.json`` (or ``BENCH_SUITE_PATH``).

Rows, in the order run (a row is a program, its input and a configuration):

- ``fib19_io``: ``programs/fib19_io.bf``, input 19 (223,689 steps), the
  headline, in this process;
- ``big22``: ``programs/big22.bf`` (1,323,044 steps, 2^22-row tables),
  right after the headline, with the largest reserve;
- ``small``: ``+++>,<[>+.<-]``, input 1 (26 steps);
- ``fib19_io_production``: fib19_io, input 19, at PRODUCTION;
- ``fib19_io_in16_production``: fib19_io, input 16 (52,931 steps: its
  largest table, memory, has 2^18 rows by ``build_meta``'s claim), at
  PRODUCTION.

big22 and every PRODUCTION row run in a child process (``--one ROW``), so
that running out of device memory there cannot poison the rows after it:
the child catches ``torch.cuda.OutOfMemoryError`` by its type and reports
the peak bytes and the stage it was in. A child that fails (no result line,
or an error) is run once more; then its error is the row's result.

DEFAULT is the prover's default, ``PcsConfig(log_max_rows=0)``; PRODUCTION
is ``PcsConfig(log_blowup=4, n_queries=30, pow_bits=16)`` (136 conjectured
bits, docs/SECURITY.md). Both keep the prover's automatic ladder top
(``log_max_rows=0``, the largest table): a fixed top of 24 would commit a
2^28-leaf preprocessed tree at blowup 4 whatever the program.

Left out against ``bench.py``: the reference's bundled programs (fib19.bf,
collatz.bf, sierpinski.bf and the hello programs), which are not in this
repository, and with them its capacity-refusal row; the refusal is covered
by ``tests/test_torch_e2e.py::test_capacity_refusal``. There is no warm-up
step: the port compiles nothing per shape, so the cold prove is its
warm-up (the kernels are built before it: ``kernel_build_s``).

Per row: the VM trace's time and steps; a cold prove with the prover's
phase times (``air.PhaseTimer``); WARM_RUNS warm proves, every run listed,
the best as ``warm_prove_s``; the peak device bytes after a reset, of the
cold prove and of the warm proves; the proof's sha256, held to the JAX
package's where one is recorded (``REFERENCE_SHA256``; a mismatch is an
error in the row) and equal across the row's proves; ``verify_brainfuck``
in process; ``python -m stwo_brainfuck_tpu_torch.cli verify`` in a fresh
process (its wall time, interpreter and CUDA context included);
``khz = steps / (trace + warm prove) / 1e3``; the kernel launches of the
row's proves.

Environment:

- ``BENCH_PROGRAM=fib19_io|small|big22|m31|fft``: the headline's program;
  ``m31`` and ``fft`` are micro modes (a card only): the M31 chain kernel's
  multiply rate (``ops/m31_kernels.throughput_benchmark(24)``) and the
  circle-FFT kernel's butterflies a second on (8, 2^18);
- ``BENCH_CONFIG=default|production``: the headline's configuration;
- ``BENCH_SUITE=0``: the headline alone; ``BENCH_BIG=0``: no big22;
- ``BENCH_BUDGET_S`` (default 1500): the wall-clock budget in seconds;
- ``BENCH_DEVICES=D``: also prove the headline on a one-process mesh of D
  shards (``parallel/mesh.make_mesh``);
- ``BENCH_DISTRIBUTED=W``: also prove it in W processes, one shard each
  (``parallel/multihost``; NCCL, one card a process; ``STWO_BF_BACKEND=gloo``
  for processes that share a card or run on the CPU). Both spread rows must
  give the one-device proof's bytes;
- ``BENCH_DEVICE=cpu``: as ``--device cpu``; ``BENCH_SUITE_PATH``: where the
  detail goes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from . import air
from .core.pcs import PcsConfig
from .vm.compiler import compile_program
from .vm.machine import create_test_machine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                          "bench_suite.json")

SMALL_CODE = "+++>,<[>+.<-]"
# program -> (source file under programs/, or None for SMALL_CODE; default input)
PROGRAMS = {
    "fib19_io": ("fib19_io.bf", bytes([19])),
    "big22": ("big22.bf", b""),
    "small": (None, b"\x01"),
}
CONFIGS = {
    "default": PcsConfig(log_max_rows=0),
    "production": PcsConfig(log_blowup=4, n_queries=30, pow_bits=16, log_max_rows=0),
}
# fib19_io's input whose largest table has 2^18 rows (memory; processor and
# instruction 2^16): 52,931 steps. Its composition is committed at 2^26
# leaves at PRODUCTION, against 2^28 at input 19.
FIB_2_18_INPUT = bytes([16])

# sha256 of json.dumps(proof, sort_keys=True) of the JAX package's proofs:
# stwo_brainfuck_tpu.air.prove_brainfuck on the CPU (JAX_PLATFORMS=cpu) of
# the row's program and input at the row's configuration; the port's proofs
# are byte-identical on the CPU and on the card.
REFERENCE_SHA256 = {
    "small": "ff791b1d69f378cb26ffaba5fd7e5ef59e375e60a39e6ae89333ec77b3994b52",
    "fib19_io": "05c19f764ada70a3d6b8bc814d24bc6baf50cf1bde7ca979242eb61de4950860",
    # the small program at the CLI's --pow-bits 16 (the device grind's path)
    "small_pow16": "c8343b33e0d5cdf0c6ef2fd4662bdf782403d60fcf6bf154a494de2b1a3f3e45",
    # the small program at PRODUCTION (tests/test_torch_production.py
    # recomputes it from the JAX package)
    "small_production": "ae26e0600fdf9b620e60c0c0d404cb19fe81b33db86995a58f2307e2ff24637e",
    # fib19_io at input 10 (3,043 steps; tests/test_torch_claimed_pull.py
    # recomputes it from the JAX package under -m slow)
    "fib19_io_in10": "415e897e29ba78c01bf280e971682811abf9e1c6e62362ac057059daed4aa3e2",
}

WARM_RUNS = 3
SUITE = ("big22", "small", "fib19_io_production", "fib19_io_in16_production")
# wall-clock seconds a row needs to be attempted (a child process, its CUDA
# context, a cold and three warm proves, verifies, a fresh-process verify,
# and one retry's worth for the near-capacity rows; on an H100 80GB HBM3 at
# 700 W fib19_io_production's cold and three warm proves take 5.6 s and its
# fresh-process verify 10.2 s)
RESERVE_S = {"big22": 300.0, "fib19_io_production": 240.0, "fib19_io_in16_production": 120.0}
DEFAULT_RESERVE_S = 60.0
# the last stdout line of a child process (--one) starts with this
ROW_TAG = "BENCH_ROW "
# test seam: BENCH_CHILD_FAULT=oom|die|hang makes every child process raise
# torch.cuda.OutOfMemoryError, exit without a line, or hang
FAULT_ENV = "BENCH_CHILD_FAULT"
FRESH_VERIFY_TIMEOUT_S = 300.0

log = logging.getLogger("stwo_brainfuck_tpu_torch.bench")


class BenchError(Exception):
    """A row's proof is wrong: a sha256 mismatch, a proof that differs
    between runs or spread paths."""


@dataclass(frozen=True)
class Row:
    program: str
    input: bytes
    config: str

    @property
    def name(self) -> str:
        name = self.program
        if self.input != PROGRAMS[self.program][1]:
            name += f"_in{self.input[0]}"
        return name + ("_production" if self.config == "production" else "")

    def source(self) -> str:
        path = PROGRAMS[self.program][0]
        if path is None:
            return SMALL_CODE
        with open(os.path.join(ROOT, "programs", path)) as f:
            return f.read()

    @property
    def isolated(self) -> bool:
        """Near capacity: run in a child process."""
        return self.program == "big22" or self.config == "production"


def _known_rows() -> Dict[str, Row]:
    rows = [Row(p, inp, c) for p, (_, inp) in PROGRAMS.items() for c in CONFIGS]
    rows.append(Row("fib19_io", FIB_2_18_INPUT, "production"))
    return {r.name: r for r in rows}


ROWS = _known_rows()


def proof_sha256(proof: dict) -> str:
    return hashlib.sha256(json.dumps(proof, sort_keys=True).encode()).hexdigest()


def card_string(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them (the
    bench's numbers depend on both), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    res = subprocess.run(["nvidia-smi", f"--id={device.index or 0}",
                          "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


class Children:
    """The processes the bench starts: run one or several at once, and kill
    what is still running (on a signal)."""

    def __init__(self):
        self.running: List[subprocess.Popen] = []

    def run(self, cmds: List[List[str]], timeout: float, env=None) -> List[tuple]:
        """Start every command at once; (returncode, stdout, stderr) of each.
        A command still running after `timeout` seconds is killed (its
        returncode is then negative)."""
        procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for c in cmds]
        self.running += procs
        deadline = time.monotonic() + timeout
        out = []
        try:
            for p in procs:
                try:
                    o, e = p.communicate(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    o, e = p.communicate()
                    e += f"\nkilled after {timeout:.0f} s"
                out.append((p.returncode, o, e))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                self.running.remove(p)
        return out

    def kill_all(self) -> None:
        for p in list(self.running):
            if p.poll() is None:
                p.kill()


class Progress:
    """Where a row is: its stage, and the prover's phase within a timed
    prove (the phase an out-of-memory error is reported in)."""

    def __init__(self):
        self.stage = "start"
        self.timer: Optional[air.PhaseTimer] = None

    def where(self) -> str:
        return self.stage + (f": {self.timer.current()}" if self.timer is not None else "")


def _peaks(devices) -> List[int]:
    return [torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"]


def _reset_peaks(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _launch_counts() -> Dict[str, int]:
    from .ops import (blake2s_kernels, circle_fft, constraint_kernels, fri_kernels, oods_kernels,
                      quotient_kernels, table_kernels)

    return {"fft": circle_fft.KERNEL.launches, **blake2s_kernels.KERNELS.launches,
            "quotients": quotient_kernels.KERNEL.launches,
            **constraint_kernels.KERNELS.launches, "oods": oods_kernels.KERNEL.launches,
            "fri_fold": fri_kernels.KERNEL.launches, "tables": table_kernels.KERNEL.launches}


def _plain_cuda_calls() -> Dict[str, int]:
    """The plain versions' calls on CUDA tensors and the host table pass's
    calls (0 on a card's prove path)."""
    from .components import device_build
    from .core import blake2s, fft, fri, poly, quotients
    from .framework import component
    from .ops import table_kernels

    return {"fft": fft.PLAIN_CUDA_CALLS, "blake2s": blake2s.PLAIN_CUDA_CALLS,
            "quotients": quotients.PLAIN_CUDA_CALLS, "constraints": component.PLAIN_CUDA_CALLS,
            "oods": poly.PLAIN_CUDA_CALLS, "fri": fri.PLAIN_CUDA_CALLS,
            "tables": device_build.META_CALLS + table_kernels.PLAIN_CUDA_CALLS}


def fresh_verify(proof: dict, device: torch.device, children: Children) -> dict:
    """``cli verify`` of the proof in a new process on `device`'s type: its
    wall time and the verify_brainfuck call's own, as the CLI logs it."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "proof.json")
        with open(path, "w") as f:
            json.dump(proof, f)
        t0 = time.perf_counter()
        [(rc, _, err)] = children.run(
            [[sys.executable, "-m", "stwo_brainfuck_tpu_torch.cli", "verify", path,
              "--device", str(device)]], FRESH_VERIFY_TIMEOUT_S,
            env=dict(os.environ, STWO_BF_LOG="info"))
        process_s = time.perf_counter() - t0
    found = [ln for ln in err.splitlines() if "Verification OK (" in ln]
    if rc != 0 or not found:
        raise BenchError(f"fresh-process verify exited {rc}: {err[-800:]}")
    return {"fresh_verify_s": process_s,
            "fresh_verify_call_s": float(found[-1].split("Verification OK (")[1].split(" s)")[0])}


def run_program(row: Row, device, children: Children, mesh=None, warm_runs: int = WARM_RUNS,
                with_fresh_verify: bool = True, progress: Optional[Progress] = None) -> dict:
    """Trace, prove cold (phase times), prove `warm_runs` times warm, verify
    (in process and, with_fresh_verify, in a new process) one row on
    `device`, or on `mesh` (whose home is `device`). Raises BenchError if a
    proof's sha256 differs from the JAX package's recorded one or between
    runs."""
    progress = progress or Progress()
    device = air.canonical_device(device) if mesh is None else mesh.home
    devices = {device} if mesh is None else set(mesh.local_devices)
    config = CONFIGS[row.config]
    progress.stage = "trace"
    code = compile_program(row.source())
    t0 = time.perf_counter()
    machine = create_test_machine(code, row.input)
    machine.execute()
    trace_s = time.perf_counter() - t0
    steps = len(machine.trace())
    launches, plain = _launch_counts(), _plain_cuda_calls()

    progress.stage = "cold prove"
    _reset_peaks(devices)
    progress.timer = timer = air.PhaseTimer(device)
    t0 = time.perf_counter()
    proof = air.prove_brainfuck(machine, config, device=device, timer=timer, mesh=mesh)
    _sync(devices)
    cold_s = time.perf_counter() - t0
    progress.timer = None
    cold_peaks = _peaks(devices)
    sha = proof_sha256(proof)
    want = REFERENCE_SHA256.get(row.name)
    if want is not None and sha != want:
        raise BenchError(f"{row.name}: proof sha256 {sha} != the JAX package's {want}")

    progress.stage = "verify"
    t0 = time.perf_counter()
    air.verify_brainfuck(proof, device=device)
    verify_s = time.perf_counter() - t0

    _reset_peaks(devices)
    warm = []
    for run in range(warm_runs):
        progress.stage = f"warm prove {run + 1}"
        t0 = time.perf_counter()
        again = air.prove_brainfuck(machine, config, device=device, mesh=mesh)
        _sync(devices)
        warm.append(time.perf_counter() - t0)
        if proof_sha256(again) != sha:
            raise BenchError(f"{row.name}: warm prove {run + 1} differs from the cold prove")
    warm_peaks = _peaks(devices)
    after, plain_after = _launch_counts(), _plain_cuda_calls()
    best = min(warm) if warm else cold_s
    out = {
        "program": row.program, "input": list(row.input), "config": row.config,
        "pcs_config": config.to_json(), "steps": steps, "trace_ms": trace_s * 1e3,
        "claim_max_log": max(proof["claim"].values()),
        "cold_prove_s": cold_s, "cold_phases_s": timer.seconds,
        "warm_prove_s": best, "warm_runs_s": warm, "total_s": trace_s + best,
        "khz": steps / (trace_s + best) / 1e3, "proof_bytes": len(json.dumps(proof)),
        "sha256": sha, "matches_jax": None if want is None else True,
        "verified": True, "verify_s": verify_s,
        "cold_peak_bytes": max(cold_peaks) if cold_peaks else None,
        "warm_peak_bytes": max(warm_peaks) if warm_peaks else None,
        "kernel_launches": {k: after[k] - launches[k] for k in after},
        "plain_cuda_calls": {k: plain_after[k] - plain[k] for k in plain},
        "device": str(device),
    }
    if mesh is not None:
        out["shards"] = mesh.size
    if with_fresh_verify:
        progress.stage = "fresh verify"
        out.update(fresh_verify(proof, device, children))
    return out


# ---------------------------------------------------------------------------
# Child processes
# ---------------------------------------------------------------------------

def _child_cmd(row: Row, device: torch.device, rank=None, world=None, coordinator=None):
    cmd = [sys.executable, "-m", "stwo_brainfuck_tpu_torch.bench", "--one", row.name,
           "--device", device.type]
    if world:
        cmd += ["--rank", str(rank), "--world", str(world), "--coordinator", coordinator]
    return cmd


def _row_line(stdout: str) -> Optional[dict]:
    lines = [ln for ln in stdout.splitlines() if ln.startswith(ROW_TAG)]
    return json.loads(lines[-1][len(ROW_TAG):]) if lines else None


def child_main(args, device: torch.device) -> int:
    """--one ROW: run one row and print its result as the last stdout line
    (an error, an out-of-memory error with its peak and stage, included)."""
    row = ROWS[args.one]
    progress = Progress()
    children = Children()
    mesh = None
    cuda = device.type == "cuda"
    try:
        fault = os.environ.get(FAULT_ENV)
        if fault == "die":
            os._exit(3)
        if fault == "hang":
            time.sleep(3600)  # until the parent kills it
        if args.world:
            from .parallel import multihost

            multihost.initialize(args.coordinator, args.world, args.rank, device=str(device))
            mesh = multihost.global_mesh()
            device = mesh.home
        if cuda:
            from .ops import (blake2s_kernels, circle_fft, constraint_kernels, nvcc,
                              quotient_kernels)

            nvcc.build_all([circle_fft.KERNEL.lib, blake2s_kernels.KERNELS.lib,
                            quotient_kernels.KERNEL.lib, constraint_kernels.KERNELS.lib,
                            constraint_kernels.KERNELS.scan_lib])
        if fault == "oom":
            raise torch.cuda.OutOfMemoryError("simulated by BENCH_CHILD_FAULT=oom")
        result = run_program(row, device, children, mesh=mesh,
                             with_fresh_verify=not args.rank, progress=progress)
        if args.world:
            result["backend"] = torch.distributed.get_backend()
    except torch.cuda.OutOfMemoryError as exc:
        result = {"error": f"OutOfMemoryError: {exc}", "oom": True, "stage": progress.where(),
                  "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None}
    except Exception as exc:  # the row's result: the parent records it
        traceback.print_exc()
        result = {"error": f"{type(exc).__name__}: {exc}", "stage": progress.where()}
    finally:
        if args.world:
            from .parallel import multihost

            multihost.shutdown()
    print(ROW_TAG + json.dumps({"row": row.name, "rank": args.rank or 0, "result": result}),
          flush=True)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_isolated(row: Row, device: torch.device, children: Children, timeout: float,
                 world: int = 0) -> dict:
    """The row in a child process (with world > 0: in `world` processes, one
    shard each, the coordinator's result with every process's peaks); run
    once more if it fails."""
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    result: dict = {}
    for attempt in (1, 2):
        t_start = time.monotonic()
        if world:
            coordinator = f"127.0.0.1:{_free_port()}"
            cmds = [_child_cmd(row, device, r, world, coordinator) for r in range(world)]
        else:
            cmds = [_child_cmd(row, device)]
        outs = children.run(cmds, timeout, env=env)
        lines = [_row_line(o) for _, o, _ in outs]
        if any(ln is None for ln in lines):
            rc, _, err = next(o for o, ln in zip(outs, lines) if ln is None)
            result = {"error": f"a child process exited {rc} without a result line: "
                               f"{err.strip()[-300:]}"}
        else:
            results = [ln["result"] for ln in lines]
            result = next((r for r in results if "error" in r), results[0])
            if world and "error" not in result:
                shas = {r["sha256"] for r in results}
                if len(shas) != 1:
                    result = {"error": f"the {world} processes' proofs differ: {sorted(shas)}"}
                else:
                    result = dict(results[0], world=world,
                                  process_cold_peak_bytes=[r["cold_peak_bytes"] for r in results],
                                  process_warm_peak_bytes=[r["warm_peak_bytes"] for r in results])
        result["attempts"] = attempt
        if "error" not in result:
            return result
        timeout -= time.monotonic() - t_start
        if timeout <= 0:
            break
        log.info("%s: attempt %d failed (%s); once more", row.name, attempt,
                 result["error"][:200])
    return result


# ---------------------------------------------------------------------------
# The report and the final line
# ---------------------------------------------------------------------------

def _sig(x, digits: int = 4):
    return None if x is None else float(f"{x:.{digits}g}")


def compact_row(r: dict) -> dict:
    """A row's few fields for the final line; the detail is in the suite file."""
    if "error" in r:
        return {"error": r["error"][:80], "stage": r.get("stage"),
                **({"peak": r["peak_bytes"]} if r.get("peak_bytes") else {})}
    if "skipped" in r:
        return {"skipped": r["skipped"][:60]}
    return {"warm_s": _sig(r["warm_prove_s"]), "khz": _sig(r["khz"]), "ok": r["verified"],
            "peak": r["warm_peak_bytes"], "sha": r["sha256"][:12]}


class Report:
    """The headline, the rows' results and the one final line."""

    def __init__(self, headline: Row, planned: List[str], budget_s: float, device: str,
                 suite_path: str, t_start: float):
        self.headline = headline
        self.planned = planned
        self.budget_s = budget_s
        self.device = device
        self.suite_path = suite_path
        self.t_start = t_start
        self.head: Optional[dict] = None
        self.results: Dict[str, dict] = {}
        self.emitted = False

    def remaining(self) -> float:
        return self.budget_s - (time.time() - self.t_start)

    def record(self, name: str, result: dict) -> None:
        self.results[name] = result
        if name == self.headline.name and "error" not in result:
            self.head = result
        print(f"# {name}: {json.dumps(result)}", file=sys.stderr, flush=True)

    def suite(self, not_reached: str) -> Dict[str, dict]:
        """Every planned row: its result, or `not_reached`."""
        return {name: self.results.get(name, {"skipped": not_reached}) for name in self.planned}

    def write_suite(self, not_reached: str = "not reached") -> None:
        os.makedirs(os.path.dirname(self.suite_path), exist_ok=True)
        with open(self.suite_path, "w") as f:
            json.dump({"device": self.device, "rows": self.suite(not_reached)}, f, indent=1)

    def final_line(self, partial: str = "", not_reached: str = "not reached") -> str:
        h = self.head
        row = self.headline
        metric = f"{row.program}.bf prove wall-clock (trace+proof, warm)"
        if row.config == "production":
            metric += ", production config"
        return json.dumps({
            "metric": metric, "value": _sig(h["total_s"], 6), "unit": "s",
            "steps": h["steps"], "proof_khz": _sig(h["khz"]),
            "cold_prove_s": _sig(h["cold_prove_s"]),
            "warm_runs_s": [_sig(t) for t in h["warm_runs_s"]],
            "verify_s": _sig(h["verify_s"]), "fresh_verify_s": _sig(h.get("fresh_verify_s")),
            "proof_bytes": h["proof_bytes"], "peak_bytes": h["warm_peak_bytes"],
            "cold_peak_bytes": h["cold_peak_bytes"], "sha256": h["sha256"],
            "verified": h["verified"], "config": row.config, "device": self.device,
            "elapsed_s": round(time.time() - self.t_start, 1), "budget_s": self.budget_s,
            "partial": partial,
            "suite": {k: compact_row(v) for k, v in self.suite(not_reached).items()
                      if k != row.name},
        }, separators=(",", ":"))

    def emit(self, partial: str = "", not_reached: str = "not reached") -> bool:
        """Print the final line, once, if there is a headline."""
        if self.emitted or self.head is None:
            return False
        self.emitted = True
        try:
            self.write_suite(not_reached)
        except OSError as exc:
            log.warning("suite file not written: %s", exc)
        print(self.final_line(partial, not_reached), flush=True)
        return True


# ---------------------------------------------------------------------------
# Micro modes
# ---------------------------------------------------------------------------

def _elapsed_s(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def fft_benchmark(device, log_n: int = 18, batch: int = 8, k_lo: int = 8,
                  k_hi: int = 32) -> dict:
    """The circle-FFT kernel's butterflies a second on (batch, 2^log_n), as
    bench.py measures the JAX package's: a 2^n transform is n * 2^(n-1)
    butterflies a row; the rate is the slope between k_lo and k_hi
    back-to-back transforms (best of 3, CUDA events), which cancels the
    fixed cost of a run."""
    from .ops import circle_fft

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, 2**31 - 1, (batch, 1 << log_n)).astype(np.int32),
                        device=device)
    butterflies = batch * log_n * (1 << (log_n - 1))
    launches = circle_fft.KERNEL.launches
    out = {}
    for op, fn in (("evaluate", circle_fft.evaluate), ("interpolate", circle_fft.interpolate)):
        def run(k, fn=fn):
            y = x
            for _ in range(k):
                y = fn(y, log_n)

        times = {}
        for k in (k_lo, k_hi):
            run(k)
            times[k] = min(_elapsed_s(lambda k=k: run(k)) for _ in range(3))
        out[op] = butterflies * (k_hi - k_lo) / (times[k_hi] - times[k_lo])
    out["kernel_launches"] = circle_fft.KERNEL.launches - launches
    return out


def micro(mode: str, device: torch.device) -> int:
    if device.type != "cuda":
        print(f"bench: BENCH_PROGRAM={mode} times the kernels: it needs a CUDA device",
              file=sys.stderr)
        return 1
    card = card_string(device)
    if mode == "m31":
        from .ops.m31_kernels import throughput_benchmark

        r = throughput_benchmark(log_n=24)
        line = {"metric": "M31 multiply throughput per card (mul_chain kernel, 2^24)",
                "value": round(r["kernel"] / 1e9, 2), "unit": "Gop/s",
                "paths": {"kernel": r["kernel"] / 1e9, "plain": r["plain"] / 1e9},
                "kernel_launches": r["kernel_launches"], "device": card}
    else:
        r = fft_benchmark(device)
        line = {"metric": "circle FFT butterflies per second per card (kernel, (8, 2^18))",
                "value": round(max(r["evaluate"], r["interpolate"]) / 1e9, 2),
                "unit": "Gbutterfly/s",
                "paths": {op: r[op] / 1e9 for op in ("evaluate", "interpolate")},
                "kernel_launches": r["kernel_launches"], "device": card}
    print(json.dumps(line), flush=True)
    return 0


# ---------------------------------------------------------------------------
# The suite walk
# ---------------------------------------------------------------------------

def _env_int(name: str) -> int:
    value = os.environ.get(name, "0")
    try:
        return int(value)
    except ValueError:
        raise SystemExit(f"bench: {name}={value!r} is not an integer")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m stwo_brainfuck_tpu_torch.bench",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default=None,
                        help="cuda (default; BENCH_DEVICE) or cpu")
    parser.add_argument("--one", choices=sorted(ROWS), help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    device = torch.device(args.device or os.environ.get("BENCH_DEVICE") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device is available (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        stream=sys.stderr)
    logging.getLogger("stwo_brainfuck_tpu_torch").setLevel(logging.WARNING)
    log.setLevel(logging.INFO)
    if args.one:
        return child_main(args, device)
    device = air.canonical_device(device)

    program = os.environ.get("BENCH_PROGRAM", "fib19_io")
    if program in ("m31", "fft"):
        return micro(program, device)
    config = os.environ.get("BENCH_CONFIG", "default")
    if program not in PROGRAMS or config not in CONFIGS:
        print(f"bench: BENCH_PROGRAM={program} / BENCH_CONFIG={config}: expected one of "
              f"{sorted(PROGRAMS) + ['m31', 'fft']} / {sorted(CONFIGS)}", file=sys.stderr)
        return 2
    shards, world = _env_int("BENCH_DEVICES"), _env_int("BENCH_DISTRIBUTED")
    headline = Row(program, PROGRAMS[program][1], config)
    suite = [n for n in SUITE if n != headline.name] if os.environ.get(
        "BENCH_SUITE", "1") != "0" else []
    # the headline spread: over a one-process mesh of D shards, and over W processes
    spread = {f"{headline.name}_d{shards}": ("mesh", shards)} if shards else {}
    if world:
        spread[f"{headline.name}_w{world}"] = ("processes", world)
    report = Report(headline, [headline.name, *suite, *spread],
                    float(os.environ.get("BENCH_BUDGET_S", "1500")), card_string(device),
                    os.environ.get("BENCH_SUITE_PATH", SUITE_PATH), time.time())
    children = Children()

    def on_signal(signum, frame):
        if report.head is None and signum == signal.SIGALRM:
            # the headline itself overran the budget: keep going (the
            # caller's own timeout is the hard stop; stopping now would
            # record nothing)
            signal.alarm(300)
            return
        children.kill_all()
        report.emit(f"signal {signum} at {report.remaining():.0f} s of the budget left",
                    f"not reached: signal {signum}")
        os._exit(0 if report.head is not None else 1)

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGALRM, on_signal)
    signal.alarm(max(60, int(report.budget_s)))

    t0 = time.perf_counter()
    if device.type == "cuda":
        from .ops import blake2s_kernels, circle_fft, constraint_kernels, nvcc, quotient_kernels

        nvcc.build_all([circle_fft.KERNEL.lib, blake2s_kernels.KERNELS.lib,
                        quotient_kernels.KERNEL.lib, constraint_kernels.KERNELS.lib,
                        constraint_kernels.KERNELS.scan_lib])
    build_s = time.perf_counter() - t0

    def run_row(row: Row, mesh=None, world: int = 0) -> dict:
        """The row in this process (on `mesh` if given), or in a child
        process (near capacity) or `world` of them, with this process's
        cached device memory handed back first."""
        if world or (row.isolated and mesh is None):
            air.clear_caches()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            return run_isolated(row, device, children, max(1.0, report.remaining()), world)
        try:
            return run_program(row, device, children, mesh=mesh)
        except (BenchError, air.ProvingError, air.VerificationError, RuntimeError) as exc:
            traceback.print_exc()
            return {"error": f"{type(exc).__name__}: {exc}"}

    head = run_row(headline)
    head["kernel_build_s"] = build_s
    report.record(headline.name, head)
    if report.head is None:
        print(f"bench: the headline {headline.name} failed: {head['error']}", file=sys.stderr)
        return 1

    partial = []
    for name in suite:
        if name == "big22" and os.environ.get("BENCH_BIG", "1") == "0":
            report.record(name, {"skipped": "BENCH_BIG=0"})
            continue
        need = RESERVE_S.get(name, DEFAULT_RESERVE_S)
        if report.remaining() < need:
            report.record(name, {"skipped": f"budget ({report.remaining():.0f} s left, "
                                            f"need {need:.0f} s)"})
            partial.append(name)
            continue
        report.record(name, run_row(ROWS[name]))

    for name, (kind, n) in spread.items():
        if kind == "mesh":
            from .parallel.mesh import make_mesh

            result = run_row(headline, mesh=make_mesh(n, device.type))
        else:
            result = run_row(headline, world=n)
        if "error" not in result and result["sha256"] != report.head["sha256"]:
            result = {"error": f"{name}: proof sha256 {result['sha256']} != the one-device "
                               f"proof's {report.head['sha256']}"}
        report.record(name, result)

    signal.alarm(0)
    report.emit("skipped: " + ",".join(partial) if partial else "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
