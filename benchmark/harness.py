"""The benchmark of the PyTorch/CUDA port: one cell, one run.

A run is one client of a proving service: each request compiles its
program, runs it on the port's VM, and calls
``stwo_brainfuck_tpu_torch.air.prove_brainfuck``; it ends when the proof is
on the host. The client is a closed loop: each request is sent when the
one before has its proof. Set-up builds the kernels and proves each of
the traffic's programs once cold and a few times warm; then the window
runs for ``--seconds``. With ``--trace 1`` the run first proves a few
requests under ``torch.profiler``,
their prove phases marked as ranges that do not synchronize, and then
runs the window untraced. A cell on W > 1 cards runs W such processes in
lockstep, one a card, over the port's multi-process prover (ranks.py).

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by name: ``configs/<config>.json`` (the path
BENCHMARK.json gives), ``traffic/<traffic>.json``,
``workloads/<cell>.json`` (with each traffic entry's claim) and
``metrics/<metric>.py`` (a ``read(run)`` that returns the number, or None
where the run has nothing to read; a metric `<base>.<qualifier>` without a
file of its own reads with `<base>`'s, so a second name for the same
quantity in other cells needs no copied reader).

After the window the proofs of a sample of requests, drawn from the seed,
are judged by ``reference/``, which shares no code with the port.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

import ranks
from arith import busy_union
from traffic import Traffic

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Top-level module names the process may not hold once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "stwo_brainfuck_tpu")


class SetupError(Exception):
    pass


# ---------------------------------------------------------------------------
# The cell, found by name
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    name: str
    config: dict          # the PcsConfig's four fields, as run
    traffic: Traffic
    spec: dict            # workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.spec["chips"])

    @property
    def claims(self) -> Dict[str, Dict[str, int]]:
        """Each traffic entry's claim (each component's log size)."""
        return {e: {k: int(v) for k, v in c.items()} for e, c in self.spec["claims"].items()}


PCS_KEYS = ("log_blowup", "n_queries", "pow_bits", "log_max_rows")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str):
    """The end-to-end and per-layer metrics that `cell` reports: a metric
    with `workloads` where that lists the cell; a per-layer metric without
    it where the cell reports the end-to-end metric it moves."""
    def listed(m):
        return cell in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if listed(m) in (True, None)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if listed(m) or (listed(m) is None and m["moves"] in names)]
    return e2e, per


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SetupError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    bench_dir = root / "benchmark"
    with open(bench_dir / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = Traffic.from_json(entry["traffic"], json.load(f))
    with open(bench_dir / "workloads" / f"{name}.json") as f:
        spec = json.load(f)
    if (spec["config"], spec["traffic"], int(spec["chips"])) != (
            entry["config"], entry["traffic"], int(entry["chips"])):
        raise SetupError(f"workloads/{name}.json disagrees with BENCHMARK.json")
    missing = {e.name for e in traffic.entries} - set(spec["claims"])
    if missing:
        raise SetupError(f"workloads/{name}.json gives no claim for {sorted(missing)}")
    e2e, per = cell_metrics(bench, name)
    return Cell(name, {k: int(config[k]) for k in PCS_KEYS}, traffic, spec, e2e, per)


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """metrics/<name>.py's `read`, or, without that file, the reader of the
    name with its last `.<qualifier>` taken off, and so on."""
    base = name
    while not (root / "benchmark" / "metrics" / f"{base}.py").exists() and "." in base:
        base = base.rsplit(".", 1)[0]
    path = root / "benchmark" / "metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def list_names(root: Path = ROOT) -> dict:
    """Every cell, configuration, traffic mix and metric the files hold."""
    d = root / "benchmark"
    return {kind: sorted(p.stem for p in (d / kind).glob(ext))
            for kind, ext in (("workloads", "*.json"), ("configs", "*.json"),
                              ("traffic", "*.json"), ("metrics", "*.py"))}


# ---------------------------------------------------------------------------
# Phase marks: the `timer=` that prove_brainfuck calls at each phase's end
# ---------------------------------------------------------------------------

class PhaseMarks:
    """Each prove phase as a torch.profiler range that does not
    synchronize (range k is named at its mark), and, on a card, the
    allocator's peak within each phase (read and reset at each mark: the
    allocator's counters live on the host)."""

    def __init__(self, cuda: bool):
        import torch

        self._torch = torch
        self.cuda = cuda
        self.names: Dict[int, str] = {}    # range id -> phase
        self.peaks: Dict[str, int] = {}    # phase -> largest peak seen
        self._n = 0
        self._range = None

    def start(self) -> None:
        if self.cuda:
            self._torch.cuda.reset_peak_memory_stats()
        self._open()

    def _open(self) -> None:
        self._range = self._torch.profiler.record_function(f"bench.phase.{self._n}")
        self._range.__enter__()

    def mark(self, name: str) -> None:
        self._range.__exit__(None, None, None)
        self.names[self._n] = name
        self._n += 1
        if self.cuda:
            peak = self._torch.cuda.max_memory_allocated()
            self.peaks[name] = max(self.peaks.get(name, 0), peak)
            self._torch.cuda.reset_peak_memory_stats()
        self._open()

    def stop(self) -> None:
        self._range.__exit__(None, None, None)
        self.names[self._n] = "return"
        self._n += 1


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

@dataclass
class Request:
    entry: str        # the traffic entry it was drawn from
    steps: int
    latency_s: float
    vm_s: float
    start: float
    end: float
    traced: bool


@dataclass
class Kept:
    """A sampled request's inputs and what the port produced for it."""
    index: int
    source: str
    input: bytes
    output: bytes
    steps: int
    proof: dict
    claim: Dict[str, int]  # the cell's claim for the request's entry


@dataclass
class TraceData:
    window_s: float = 0.0
    busy_s: float = 0.0
    requests: int = 0
    phase_s: Dict[str, float] = field(default_factory=dict)   # summed over traced requests
    kernel_s: Dict[str, float] = field(default_factory=dict)  # device time by kernel name
    idle_gaps: Dict[str, float] = field(default_factory=dict)  # idle device time by host phase
    phase_peaks: Dict[str, int] = field(default_factory=dict)


@dataclass
class Run:
    cell: Cell
    seed: int
    trace: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    peak_bytes: int = 0
    requests: List[Request] = field(default_factory=list)
    traced: Optional[TraceData] = None
    kept: List[Kept] = field(default_factory=list)
    failed: int = 0
    peak_by_card: List[int] = field(default_factory=list)  # a cell on several cards


def sample_size(cell: Cell) -> int:
    return int(cell.spec["checked_requests"])


class Reservoir:
    """A uniform sample of k of the window's requests, drawn from the seed
    as they come (algorithm R): only k proofs are held at a time."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed % (1 << 64), 0x5EED])
        self.items: List[Kept] = []
        self.seen = 0

    def offer(self, make: Callable[[], Kept]) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = make()


def prove_request(cell: Cell, source: str, inp: bytes, device: str, timer=None, mesh=None):
    """One request on the port: compile, run the VM, prove (on `mesh`
    where given, the process group's). Returns (machine, proof, seconds in
    the VM)."""
    from stwo_brainfuck_tpu_torch import air
    from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig
    from stwo_brainfuck_tpu_torch.vm.compiler import compile_program
    from stwo_brainfuck_tpu_torch.vm.machine import Machine

    t0 = time.perf_counter()
    machine = Machine(compile_program(source), inp)
    machine.execute()
    vm_s = time.perf_counter() - t0
    proof = air.prove_brainfuck(machine, PcsConfig(**cell.config), device=device, timer=timer,
                                mesh=mesh)
    return machine, proof, vm_s


def _steps(machine) -> int:
    return int(len(machine.trace()))


def setup(cell: Cell, seed: int, device: str, prove=prove_request) -> None:
    """For each entry of the traffic, one cold prove and `warm_proves` warm
    ones, on warm-up requests (negative indices), each checked to have the
    table sizes the cell gives that entry."""
    entries = cell.traffic.entries
    for j in range(1 + int(cell.spec["warm_proves"])):
        for k, e in enumerate(entries):
            source, inp = cell.traffic.request(seed, -1 - j * len(entries) - k, e)
            _machine, proof, _ = prove(cell, source, inp, device)
            claim = {c: int(v) for c, v in proof["claim"].items()}
            if claim != cell.claims[e.name]:
                raise SetupError(f"seed {seed}, {e.name}: the claim {claim} is not the cell's "
                                 f"{cell.claims[e.name]}")


def _one(run: Run, keep: Optional["Reservoir"], i: int, device: str, prove, t_start: float,
         marks: Optional["PhaseMarks"]) -> float:
    """Request i: prove it, record it, offer it to the sample (a worker of
    a cell on several cards, with no `keep`, only proves). Returns its end
    on the window's clock."""
    import torch

    cell = run.cell
    entry = cell.traffic.entry(run.seed, i)
    source, inp = cell.traffic.request(run.seed, i, entry)
    t0 = time.perf_counter()
    rng = None
    if marks is not None:
        rng = torch.profiler.record_function(f"bench.request.{i}")
        rng.__enter__()
        marks.start()
    try:
        machine, proof, vm_s = prove(cell, source, inp, device, marks)
    except Exception as exc:  # a failed request is counted and reported
        run.failed += 1
        print(f"request {i} failed: {type(exc).__name__}: {exc}", file=sys.stderr)
        machine = proof = None
        vm_s = 0.0
    if rng is not None:
        marks.stop()
        rng.__exit__(None, None, None)
    t1 = time.perf_counter()
    if proof is not None and keep is not None:
        steps = _steps(machine)
        run.requests.append(Request(entry.name, steps, t1 - t0, vm_s, t0 - t_start,
                                    t1 - t_start, marks is not None))
        keep.offer(lambda: Kept(i, source, inp, machine.output_bytes(), steps, proof,
                                cell.claims[entry.name]))
    return t1 - t_start


def window(run: Run, device: str, seconds: float, prove=prove_request,
           group: Optional[ranks.Group] = None) -> None:
    """The measured window: requests back to back until `seconds` have
    passed; the last request sent in time ends it. A traced run first
    proves the cell's `traced_requests` under the profiler (the traced window),
    stops it, and then runs the window untraced. In a process group rank
    0's clock ends the window for every rank, and rank 0 alone keeps the
    sample."""
    import torch

    cuda = device.startswith("cuda")
    keep = Reservoir(sample_size(run.cell), run.seed) if group is None or group.rank == 0 else None
    i = 0
    marks = None
    if run.trace:
        from torch.profiler import ProfilerActivity, profile

        marks = PhaseMarks(cuda)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(int(run.cell.spec["traced_requests"])):
                _one(run, keep, i, device, prove, t0, marks)
            if cuda:
                torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        i = int(run.cell.spec["traced_requests"])
        run.traced = read_trace(prof, marks, traced_s, len(run.requests))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    while _go_on(group, _one(run, keep, i, device, prove, t_start, None) < seconds):
        i += 1
    run.window_s = time.perf_counter() - t_start
    if cuda:  # the marker resets the peak at each phase: its phases' peaks count too
        run.peak_bytes = max([int(torch.cuda.max_memory_allocated())]
                             + list(marks.peaks.values() if marks else []))
    run.kept = keep.items if keep else []


def _go_on(group: Optional[ranks.Group], more: bool) -> bool:
    return more if group is None else group.go_on(more)


def read_trace(prof, marks: PhaseMarks, window_s: float, n_requests: int) -> TraceData:
    """Phase seconds (host ranges), device time by kernel, the device's
    busy time (the union of kernel and copy intervals) and its idle gaps,
    each gap put down to the host phase that was running when it began."""
    from torch.autograd import DeviceType

    td = TraceData(window_s=window_s, requests=n_requests, phase_peaks=dict(marks.peaks))
    ranges = []  # (start us, end us, phase) on the host
    spans = []
    for ev in prof.events():
        name = ev.name
        if ev.device_type == DeviceType.CPU and name.startswith("bench.phase."):
            phase = marks.names.get(int(name.rsplit(".", 1)[1]), "?")
            dt = ev.time_range.elapsed_us() / 1e6
            td.phase_s[phase] = td.phase_s.get(phase, 0.0) + dt
            ranges.append((ev.time_range.start, ev.time_range.end, phase))
        elif ev.device_type == DeviceType.CPU and name.startswith("bench.request."):
            ranges.append((ev.time_range.start, ev.time_range.end, "vm and request"))
        elif ev.device_type == DeviceType.CUDA and not name.startswith("bench."):
            a, b = ev.time_range.start, ev.time_range.end
            spans.append((a, b))
            td.kernel_s[name] = td.kernel_s.get(name, 0.0) + (b - a) / 1e6
    busy, gaps = busy_union(spans)
    td.busy_s = busy / 1e6
    # the innermost host range open at each gap's start (phases lie inside
    # their request's range, so the shortest range that holds it)
    ranges.sort(key=lambda r: r[1] - r[0])
    for a, b in gaps:
        where = next((p for s, e, p in ranges if s <= a < e), "between requests")
        td.idle_gaps[where] = td.idle_gaps.get(where, 0.0) + (b - a) / 1e6
    return td


# ---------------------------------------------------------------------------
# After the window
# ---------------------------------------------------------------------------

def free_program_state(device: str) -> None:
    from stwo_brainfuck_tpu_torch import air

    air.clear_caches()
    gc.collect()
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def judge(run: Run, device: str) -> Dict[str, dict]:
    """The numbers compared, each with its limit: reference/check.py on
    the sampled requests."""
    from reference.check import judge_requests

    counts = judge_requests(run.kept, run.cell.config, device)
    counts["failed_requests"] = run.failed
    return {k: {"value": v, "limit": 0} for k, v in counts.items()}


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def metrics_of(run: Run, root: Path = ROOT) -> Dict[str, dict]:
    wanted = run.cell.per_layer if run.trace else run.cell.end_to_end
    out = {}
    for m in wanted:
        value = metric_reader(m["name"], root)(run)
        if value is None:
            continue
        if not (isinstance(value, (int, float)) and math.isfinite(value)):
            raise ValueError(f"metric {m['name']} read {value!r}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(td: TraceData) -> dict:
    ops = sorted(td.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(td.idle_gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str,
             started: float, root: Path = ROOT, prove=prove_request,
             cores: Optional[List[int]] = None) -> dict:
    """One run of one cell: set-up, window, the metrics, the judgement.
    Returns the result line's object (without `device`'s card fields). A
    cell on several cards runs as rank 0 of its process group
    (`_run_ranks`), with the port's prove; `cores` are the cores the
    process may use, which the ranks share out."""
    cell = load_cell(name, root)
    run = Run(cell, seed, trace)
    if cell.chips == 1:
        setup(cell, seed, device)
        run.setup_s = time.perf_counter() - started
        window(run, device, seconds, prove)
    else:
        _run_ranks(run, seconds, device, started, root, cores)
    metrics = metrics_of(run, root)
    free_program_state(device)
    checks = judge(run, device)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": len(run.requests) + run.failed,
           "failed": run.failed, "metrics": metrics}
    dev = {"count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    if run.peak_by_card:
        dev["memory_peak_bytes_by_card"] = run.peak_by_card
    if run.traced is not None:
        dev.update(busy_s=run.traced.busy_s, window_s=run.traced.window_s)
        out["breakdown"] = breakdown(run.traced)
    out["device"] = dev
    out["checks"] = checks
    return out


def _run_ranks(run: Run, seconds: float, device: str, started: float, root: Path,
               cores: Optional[List[int]]) -> None:
    """Rank 0 of a cell on W > 1 cards: start the other ranks, and with
    them the set-up and the window, each request proved by every rank on
    the process group's mesh; then take every card's readings."""
    cell = run.cell
    argv = ["--workload", cell.name, "--seed", str(run.seed), "--seconds", repr(seconds),
            "--trace", str(int(run.trace)), "--root", str(root)]
    group = ranks.Group.start(argv, cell.chips, len(cell.traffic.entries), device, cores)
    try:
        prove = group.proving(prove_request)
        setup(cell, run.seed, device, prove)
        run.setup_s = time.perf_counter() - started
        print(f"set-up {run.setup_s:.1f} s on {cell.chips} ranks; the window opens",
              file=sys.stderr, flush=True)
        window(run, device, seconds, prove, group)
        group.finish(run)
    except BaseException:
        group.abort()
        raise


def worker(args) -> int:
    """Rank `args.rank` of a cell on several cards: set-up and the window in
    lockstep with rank 0, then its card's readings to rank 0. It prints
    nothing on standard output."""
    if args.cores:
        os.sched_setaffinity(0, [int(c) for c in args.cores.split(",")])
    try:
        cell = load_cell(args.workload, Path(args.root))
        group = ranks.Group.join(cell.chips, len(cell.traffic.entries), args.device)
        run = Run(cell, args.seed, bool(args.trace))
        prove = group.proving(prove_request)
        setup(cell, args.seed, args.device, prove)
        window(run, args.device, args.seconds, prove, group)
        group.finish(run)
    except Exception:
        print(f"rank {args.rank}: {traceback.format_exc()}", file=sys.stderr, flush=True)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"rank {args.rank} holds {', '.join(bad)}: the port must not load JAX or the JAX "
              "package", file=sys.stderr)
        return 3
    return 0


def main(argv: List[str], started: float, cores: Optional[List[int]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a worker of a cell on several cards, as rank 0 starts it (ranks.py)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--root", default=str(ROOT), help=argparse.SUPPRESS)
    ap.add_argument("--cores", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank:
        return worker(args)

    import torch

    import stwo_brainfuck_tpu_torch.air  # noqa: F401  (the system under test: fail early without it)

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    kind = torch.cuda.get_device_name(0)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", started,
                   cores=cores)
    bad = forbidden_modules()
    if bad:
        print(f"the process holds {', '.join(bad)}: the port must not load JAX or the JAX "
              "package", file=sys.stderr)
        return 3
    out["device"] = {"platform": "gpu", "kind": kind, **out["device"]}
    checks = out.pop("checks")
    out["checks"] = checks  # the key of its own comes last
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
