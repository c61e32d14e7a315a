"""The program's spans against the device's idle time, in one benchmark
cell's traced requests (card only).

    cd <checkout>; python3 <this checkout>/tools/span_idle.py --cell production.fib19_io \
        [--seed N] [--sessions off,on,on,off] [--devices D] [--out DIR]

Set-up as the benchmark's (`benchmark/harness.setup` of the checkout the
command starts from); then each session proves the cell's
`traced_requests` requests back to back under torch.profiler as the
benchmark's `--trace 1` run does (`harness._one` with its `PhaseMarks`):
`on` records each request (`tracing.record` around its VM and prove, the
program's spans as `bf.` profiler ranges), `off` does not. For each
session: `harness.read_trace`'s readings from the profile with the `bf.`
ranges' device-side annotations left out, and the busy time those add
where they are counted; the mean latency of a traced request; for `on`
sessions also, a traced request: each span's self time, the counters
(`sync.*`, `quotients.powers`) and the readings `host.syncs` (their sum), `host.sync_wait_ms`
(the `sync.*` spans' self time), `decommit.host_ms` (the self time of
decommit.plan, decommit.layout, decommit.build) and `quotients.host_ms`
(quotients.claims, quotients.constants); the idle time put down to the
innermost span open through it (`tracing.idle_by_span`, on the profiler's
clock), and for each phase the share of its idle time that lands in a span
inside it; the mesh's collectives and cross stages (`mesh`: each `mesh.<op>`
and `fft.cross` span's count and self time a request, and `mesh.bytes`); the profiler's synchronizing runtime calls inside the requests
beside the counters, those outside every `sync.*` span by the span they
fall in. A checkout without `stwo_brainfuck_tpu_torch/tracing.py` runs its
`off` sessions only. With `--devices D` every prove runs on a one-process
mesh of D shards over the visible cards (`parallel/mesh.make_mesh`), the
sharded path a cell on D cards proves on, in one process (card 0's
profile). Prints the card and one JSON line a session; the
whole result goes to `<out>/span_idle.<cell>.<checkout name>.json` (by default the git-ignored
`stwo_brainfuck_tpu_torch/build/`).
"""

from __future__ import annotations

import argparse
import collections
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.getcwd()
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]
# as benchmark/run.py: one host thread for the CPU libraries, the last four cores
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import harness  # noqa: E402
from stwo_brainfuck_tpu_torch import air  # noqa: E402

HAS_TRACING = importlib.util.find_spec("stwo_brainfuck_tpu_torch.tracing") is not None
if HAS_TRACING:
    from stwo_brainfuck_tpu_torch import tracing

PREFIX = "bf."
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy")
PHASES_CHECKED = ("quotients", "pow", "decommit", "tree1")


class _Events:
    """A profile's events with some left out, for harness.read_trace."""

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _session(cell, seed: int, first: int, on: bool, mesh=None) -> dict:
    run = harness.Run(cell, seed, True)
    keep = harness.Reservoir(0, seed)
    recs = []

    def prove(cell, source, inp, device, timer):
        if not on:
            return harness.prove_request(cell, source, inp, device, timer, mesh=mesh)
        with tracing.record(first + len(recs)) as rec:
            recs.append(rec)
            return harness.prove_request(cell, source, inp, device, timer, mesh=mesh)

    n = int(cell.spec["traced_requests"])
    marks = harness.PhaseMarks(True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(first, first + n):
            harness._one(run, keep, i, "cuda", prove, t0, marks)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    events = list(prof.events())
    kept = [ev for ev in events
            if not (ev.device_type == DeviceType.CUDA and ev.name.startswith(PREFIX))]
    td = harness.read_trace(_Events(kept), marks, traced_s, len(run.requests))
    raw = harness.read_trace(_Events(events), marks, traced_s, len(run.requests))
    out = {"tracing": "on" if on else "off", "requests": len(run.requests), "failed": run.failed,
           "window_s": td.window_s, "busy_s": td.busy_s,
           "idle_share": 1 - td.busy_s / td.window_s,
           "busy_s_with_bf_annotations": raw.busy_s,
           "mean_latency_s": sum(r.latency_s for r in run.requests) / len(run.requests),
           "mean_vm_s": sum(r.vm_s for r in run.requests) / len(run.requests),
           "phase_ms": {k: 1e3 * v / td.requests for k, v in td.phase_s.items()},
           "idle_gaps_ms": {k: 1e3 * v / td.requests for k, v in
                            sorted(td.idle_gaps.items(), key=lambda kv: -kv[1])[:10]},
           "device_ops_ms": {k: 1e3 * v / td.requests for k, v in
                             sorted(td.kernel_s.items(), key=lambda kv: -kv[1])[:10]}}
    if not on:
        return out
    per = len(recs)
    own = tracing.self_times(recs)
    out.update({
        "spans_per_request": sum(len(r.spans) for r in recs) / per,
        "span_self_ms": {k: v / 1e6 / per for k, v in sorted(own.items(), key=lambda kv: -kv[1])},
        "counters": {k: v / per for k, v in
                     sorted(sum((collections.Counter(r.counters) for r in recs),
                                collections.Counter()).items())},
        **tracing.readings(recs)})
    mesh_spans = collections.Counter(s.name for r in recs for s in r.spans
                                     if s.name.startswith("mesh.") or s.name == "fft.cross")
    out["mesh"] = {k: {"per_request": n / per, "self_ms": own.get(k, 0) / 1e6 / per}
                   for k, n in sorted(mesh_spans.items())}
    out["mesh"]["mesh.bytes"] = sum(r.counters.get("mesh.bytes", 0) for r in recs) / per

    # the idle gaps on the profiler's clock, put down to the innermost bf. range
    ranges = [(ev.time_range.start, ev.time_range.end, ev.name[len(PREFIX):]) for ev in events
              if ev.device_type == DeviceType.CPU and ev.name.startswith(PREFIX)]
    requests = [(ev.time_range.start, ev.time_range.end) for ev in events
                if ev.device_type == DeviceType.CPU and ev.name.startswith("bench.request.")]
    spans = [(ev.time_range.start, ev.time_range.end) for ev in kept
             if ev.device_type == DeviceType.CUDA and not ev.name.startswith("bench.")]
    _busy, gaps = harness.busy_union(spans)
    by_name = tracing.idle_by_span(gaps, ranges)
    by_phase = {ph: {"idle_ms": idle / 1e3 / per, "self_ms": own / 1e3 / per,
                     "in_sub_spans": 1 - own / idle if idle else None}
                for ph, (idle, own) in tracing.idle_by_phase(gaps, ranges).items()}
    out["idle_spans_ms"] = {k: v / 1e3 / per for k, v in
                            sorted(by_name.items(), key=lambda kv: -kv[1])[:25]}
    out["idle_by_phase"] = {k: by_phase[k] for k in PHASES_CHECKED if k in by_phase}
    out["idle_all_phases"] = by_phase

    # the profiler's synchronizing calls inside the requests, against the counters
    at = tracing.locate(ranges)
    calls, uncounted = {}, {}
    for ev in events:
        if ev.device_type != DeviceType.CPU or ev.name not in SYNC_CALLS:
            continue
        t = ev.time_range.start
        if not any(a <= t <= b for a, b in requests):
            continue
        calls[ev.name] = calls.get(ev.name, 0) + 1
        where = at(t)
        if not where.startswith("sync."):
            uncounted[f"{ev.name} in {where}"] = uncounted.get(f"{ev.name} in {where}", 0) + 1
    out["profile_syncs"] = {k: v / per for k, v in calls.items()}
    out["profile_syncs_per_request"] = sum(calls.values()) / per
    out["profile_syncs_outside_sync_spans"] = {k: v / per for k, v in uncounted.items()}
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="span_idle.py")
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, default=4100000001)
    ap.add_argument("--sessions", default="off,on,on,off")
    ap.add_argument("--devices", type=int, default=0,
                    help="prove on a one-process mesh of this many shards")
    ap.add_argument("--out", default=os.path.join(ROOT, "stwo_brainfuck_tpu_torch", "build"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_idle: no CUDA device", file=sys.stderr)
        return 1
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-4:])
    sessions = [s for s in args.sessions.split(",") if HAS_TRACING or s == "off"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    cell = harness.load_cell(args.cell)
    mesh = None
    if args.devices:
        from stwo_brainfuck_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.devices, "cuda")

    def prove(cell, source, inp, device, timer=None):
        return harness.prove_request(cell, source, inp, device, timer, mesh=mesh)

    t0 = time.perf_counter()
    harness.setup(cell, args.seed, "cuda", prove)
    result = {"cell": args.cell, "seed": args.seed, "checkout": ROOT, "card": card.strip(),
              "devices": args.devices, "setup_s": time.perf_counter() - t0, "sessions": []}
    first = 0
    for s in sessions:
        gc.collect()  # the last session's profile is cyclic garbage: not in this one's requests
        res = _session(cell, args.seed, first, s == "on", mesh)
        first += int(cell.spec["traced_requests"])
        result["sessions"].append(res)
        print(json.dumps({"cell": args.cell, "checkout": os.path.basename(ROOT), **res}),
              flush=True)
    air.clear_caches()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"span_idle.{args.cell}.{os.path.basename(ROOT)}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
