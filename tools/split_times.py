"""Where a warm prove's time goes, for the checkout of the current
directory (one with the program's spans, stwo_brainfuck_tpu_torch/tracing.py):
its kernels built, two warm-up proves of the program (fib19_io at input
19, or big22), then one profiled prove (chip_smoke.phase_split of that
checkout: the device-busy share, the host synchronizations and their
wait, device events and kernels, the kernels that take the most device
time; default config only), one more profiled prove recorded
(tracing.record) and split inside each phase by the program's spans, and
the phases of one more prove (air.PhaseTimer, each mark synchronizing).

    python3 <this checkout>/tools/split_times.py [--production] [--program big22] [--empty-cache]

--production proves at chip_smoke.PRODUCTION (fib19_io at input 19,
committed at 2^28); --program big22 proves programs/big22.bf;
--empty-cache empties the allocator's cache before each measured prove,
as chip_smoke.py does after each of its proves, so every block a prove
takes is a fresh cudaMalloc. The split inside a phase: the host seconds of
each span inside it less the spans inside that (`tables.meta`,
`oods.kernel`, `fri.fold`, `commit.hash`, `sync.root`, ...), with its
count of calls; what no span inside covers is `other`. Beside them, in
each phase and by the innermost span open where each was issued: its
host-to-device and device-to-host copies, host syncs and their wait,
cudaMalloc calls and their host time, and the device time of its kernels
and copies (each device event counted where the host op that issued it
started). Started from another checkout's root (a commit unpacked) it
reads that commit's prover: parent and change compare in one call. Prints
the card and one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stwo_brainfuck_tpu_torch import air, tracing  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine  # noqa: E402

WARM_UP = 2
PROGRAMS = {"fib19_io": chip_smoke.FIB_INPUT, "big22": b""}  # program -> input


def _inside_split(code, inp: bytes, config) -> dict:
    """One profiled, recorded prove: for each phase its seconds, each span
    inside it by its self time and calls, and each part's copies, host
    syncs, cudaMallocs and device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    machine = create_test_machine(code, inp)
    machine.execute()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracing.record(0) as rec:
            air.prove_brainfuck(machine, config, device="cuda")
            torch.cuda.synchronize()
    spans = [(sp.start_ns, sp.end_ns, sp.name) for sp in rec.spans]
    out = {}
    for (a, b, name), ph, own in zip(spans, tracing.phase_of(spans), tracing.own_ns(rec)):
        split = out.setdefault(ph, {"s": 0.0, "parts_s": {}, "calls": {}, "other_s": 0.0,
                                    "by_part": {}})
        if name == ph:
            split["s"] += (b - a) / 1e9
            split["other_s"] += own / 1e9
        else:
            split["parts_s"][name] = split["parts_s"].get(name, 0.0) + own / 1e9
            split["calls"][name] = split["calls"].get(name, 0) + 1

    # the profiler's host events by the innermost bf. range open where each started
    prefix = tracing.PROFILER_PREFIX
    events = list(prof.events())
    ranges = [(ev.time_range.start, ev.time_range.end, ev.name[len(prefix):]) for ev in events
              if ev.device_type == DeviceType.CPU and ev.name.startswith(prefix)]
    at = tracing.locate([(a, b, f"{ph}|{name}") for (a, b, name), ph
                         in zip(ranges, tracing.phase_of(ranges))])

    def part_at(t):
        ph, _, name = at(t).partition("|")
        split = out.setdefault(ph, {"s": 0.0, "parts_s": {}, "calls": {}, "other_s": 0.0,
                                    "by_part": {}})
        return split["by_part"].setdefault(name or "other", {
            "host_to_device_copies": 0, "device_to_host_copies": 0, "host_syncs": 0,
            "sync_wait_s": 0.0, "mallocs": 0, "malloc_s": 0.0, "device_s": 0.0})

    for ev in events:
        if ev.device_type != DeviceType.CPU:
            continue
        t, us = ev.time_range.start, ev.time_range.elapsed_us()
        if "Synchronize" in ev.name:
            part = part_at(t)
            part["host_syncs"] += 1
            part["sync_wait_s"] += us / 1e6
        elif ev.name == "cudaMalloc":
            part = part_at(t)
            part["mallocs"] += 1
            part["malloc_s"] += us / 1e6
        for k in ev.kernels:
            part = part_at(t)
            part["host_to_device_copies"] += k.name.startswith("Memcpy HtoD")
            part["device_to_host_copies"] += k.name.startswith("Memcpy DtoH")
            part["device_s"] += k.duration / 1e6
    for split in out.values():
        for key in ("host_to_device_copies", "device_to_host_copies", "host_syncs",
                    "sync_wait_s", "mallocs", "malloc_s", "device_s"):
            split[key] = sum(part[key] for part in split["by_part"].values())
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="split_times.py")
    ap.add_argument("--production", action="store_true")
    ap.add_argument("--program", choices=list(PROGRAMS), default="fib19_io")
    ap.add_argument("--empty-cache", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("split_times: no CUDA device", file=sys.stderr)
        return 1
    program = args.program
    config = chip_smoke.PRODUCTION if args.production else None
    fresh = torch.cuda.empty_cache if args.empty_cache else (lambda: None)
    path = os.path.join(os.getcwd(), "programs", f"{program}.bf")
    inp = PROGRAMS[program]
    with open(path) as f:
        code = compile_program(f.read())
    for _ in range(WARM_UP):
        m = create_test_machine(code, inp)
        m.execute()
        air.prove_brainfuck(m, config, device="cuda")
    torch.cuda.synchronize()
    split = None
    if config is None:
        fresh()
        with contextlib.redirect_stdout(io.StringIO()):
            split = chip_smoke.phase_split(program, path, inp)
    fresh()
    inside = _inside_split(code, inp, config)
    m = create_test_machine(code, inp)
    m.execute()
    fresh()
    timer = air.PhaseTimer("cuda")
    torch.cuda.reset_peak_memory_stats()
    air.prove_brainfuck(m, config, device="cuda", timer=timer)
    torch.cuda.synchronize()
    print(chip_smoke._smi("name,power.limit"))
    print(json.dumps({"checkout": os.getcwd(), "program": program,
                      "config": "production" if config else "default",
                      "empty_cache": args.empty_cache,
                      "phase_split": split, "inside": inside, "phases_s": timer.seconds,
                      "peak_device_bytes": torch.cuda.max_memory_allocated()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
