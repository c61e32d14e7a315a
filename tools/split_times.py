"""Where a warm prove's time goes, for the checkout of the current
directory: its kernels built, two warm-up proves of the program (fib19_io
at input 19, or big22), then one profiled prove (chip_smoke.phase_split
of that checkout: the device-busy share, the host synchronizations and
their wait, device events and kernels, the kernels that take the most
device time; default config only), one more profiled prove split inside
its `tables`, `oods` and `fri` phases, and the phases of one more prove
(air.PhaseTimer, each mark synchronizing).

    python3 <this checkout>/tools/split_times.py [--production] [--program big22] [--empty-cache]

--production proves at chip_smoke.PRODUCTION (fib19_io at input 19,
committed at 2^28); --program big22 proves programs/big22.bf;
--empty-cache empties the allocator's cache before each measured prove,
as chip_smoke.py does after each of its proves, so every block a prove
takes is a fresh cudaMalloc. The split
inside the phases times the prover's own functions as profiler ranges,
each the host time of its calls less the ranges inside it: `tables` into
its meta pass (components/device_build.build_meta, the host pass, or
device_meta, the pass on the device), its uploads (device_build._upload,
one an array, or _stage, the one staged copy), its pull (_pull) and its
build (build_device_tables, the torch-ops build, or
ops/table_kernels.TableKernel.build, the kernel); `oods` into its bases or launch table
(poly.half_bases_at_point; ops/oods_kernels.pack, the factor table of the
first OODS kernel; ops/oods_kernels.plan, the table of the persistent one),
its contraction (poly.sample_tensor, or the OODS kernel's call less its
table) and its pull (poly.pull);
`fri` into its folds (fri._fold, or fri.fold_step), its layer commits
(merkle.commit) and their root pulls (blake2s.digest_to_bytes); what no
range covers is `other`. Beside them, in each phase: its device->host
copies, host syncs and their wait, and the device time of the kernels and
copies that start in it; and in each part: its host-to-device and
device-to-host copies, host syncs, cudaMalloc calls and their host time, and the device
time of its kernels and copies (each device event counted where the host
op that issued it started, in the innermost part around it). A function the checkout lacks is left out, so
started from another checkout's root (an older commit unpacked) it reads
that commit's prover: parent and change compare in one call. Prints the
card and one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import os
import sys
from unittest import mock

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stwo_brainfuck_tpu_torch import air  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine  # noqa: E402

WARM_UP = 2
PKG = "stwo_brainfuck_tpu_torch"
PROGRAMS = {"fib19_io": chip_smoke.FIB_INPUT, "big22": b""}  # program -> input
# (phase, part) -> the functions timed as that part, where the checkout has them
PARTS = {
    ("tables", "meta"): [("components.device_build", "build_meta"),
                         ("components.device_build", "device_meta")],
    ("tables", "upload"): [("components.device_build", "_upload"),
                           ("components.device_build", "_stage")],
    ("tables", "pull"): [("components.device_build", "_pull")],
    ("tables", "build"): [("components.device_build", "build_device_tables"),
                          ("ops.table_kernels", "TableKernel.build")],
    ("oods", "bases"): [("core.poly", "half_bases_at_point"), ("ops.oods_kernels", "pack"),
                        ("ops.oods_kernels", "plan")],
    ("oods", "contraction"): [("core.poly", "sample_tensor"),
                              ("ops.oods_kernels", "OodsKernel.sample")],
    ("oods", "pull"): [("core.poly", "pull")],
    ("fri", "folds"): [("core.fri", "_fold"), ("core.fri", "fold_step")],
    ("fri", "commits"): [("core.merkle", "commit")],
    ("fri", "root_pulls"): [("core.blake2s", "digest_to_bytes")],
}


def _ranged(label: str, fn):
    def call(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)
    return call


@contextlib.contextmanager
def _timed_parts():
    """Every function of PARTS the checkout has, wrapped in a profiler range
    named "part <phase>/<part>"."""
    with contextlib.ExitStack() as stack:
        for (phase, part), targets in PARTS.items():
            for module, path in targets:
                try:
                    owner = importlib.import_module(f"{PKG}.{module}")
                except ImportError:
                    continue
                *outer, name = path.split(".")
                for attr in outer:
                    owner = getattr(owner, attr, None)
                if owner is None or not hasattr(owner, name):
                    continue
                stack.enter_context(mock.patch.object(
                    owner, name, _ranged(f"part {phase}/{part}", getattr(owner, name))))
        yield


def _innermost(parts: list, t: float):
    """The label of the innermost part range around host time t, or None."""
    around = [(s, -e, label) for label, s, e in parts if s <= t <= e]
    return max(around)[2] if around else None


def _inside_split(code, inp: bytes, config) -> dict:
    """One profiled prove: the host seconds of each PARTS range less the
    ranges inside it, within the `tables`, `oods` and `fri` phases, and
    each part's copies, host syncs and device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    machine = create_test_machine(code, inp)
    machine.execute()
    torch.cuda.synchronize()
    with _timed_parts(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        phases = chip_smoke._ProfiledPhases()
        air.prove_brainfuck(machine, config, device="cuda", timer=phases)
        torch.cuda.synchronize()
        phases.close()
    names = {f"prove phase {k}": n for k, n in enumerate(phases.names)}
    ranges, parts, device, syncs, dtoh, issued, mallocs = {}, [], [], [], [], [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CPU and ev.name in names:
            ranges[names[ev.name]] = tr
        elif ev.device_type == DeviceType.CPU and ev.name.startswith("part "):
            parts.append((ev.name[5:], tr.start, tr.end))
        elif ev.device_type == DeviceType.CUDA and ev.name not in names:
            device.append((tr.start, tr.elapsed_us()))
            if ev.name.startswith("Memcpy DtoH"):
                dtoh.append(tr.start)
        elif "Synchronize" in ev.name:
            syncs.append((tr.start, tr.elapsed_us()))
        elif ev.name == "cudaMalloc":
            mallocs.append((tr.start, tr.elapsed_us()))
        if ev.device_type == DeviceType.CPU and ev.kernels:
            issued += [(tr.start, k.name, k.duration) for k in ev.kernels]
    by_part = {}

    def part_at(t):
        return by_part.setdefault(_innermost(parts, t), {
            "host_to_device_copies": 0, "device_to_host_copies": 0, "host_syncs": 0,
            "mallocs": 0, "malloc_s": 0.0, "device_s": 0.0})

    for t, kname, us in issued:
        part = part_at(t)
        part["host_to_device_copies"] += kname.startswith("Memcpy HtoD")
        part["device_to_host_copies"] += kname.startswith("Memcpy DtoH")
        part["device_s"] += us / 1e6
    for t, _ in syncs:
        part_at(t)["host_syncs"] += 1
    for t, us in mallocs:
        part = part_at(t)
        part["mallocs"] += 1
        part["malloc_s"] += us / 1e6
    out = {}
    for phase in ("tables", "oods", "fri"):
        r = ranges[phase]
        inside = [p for p in parts if p[0].startswith(phase + "/") and r.start <= p[1] <= r.end]
        own = {}
        for label, a, b in inside:  # at most two deep: a range less the ranges inside it
            nested = sum(e - s for lb, s, e in inside if a <= s and e <= b and (s, e) != (a, b))
            key = label.split("/", 1)[1]
            own[key] = own.get(key, 0.0) + (b - a - nested) / 1e6
        counts = {}
        for label, _, _ in inside:
            counts[label.split("/", 1)[1]] = counts.get(label.split("/", 1)[1], 0) + 1
        total = r.elapsed_us() / 1e6
        out[phase] = {
            "s": total, "parts_s": own, "calls": counts, "other_s": total - sum(own.values()),
            "device_to_host_copies": sum(r.start <= t <= r.end for t in dtoh),
            "host_syncs": sum(r.start <= t <= r.end for t, _ in syncs),
            "sync_wait_s": sum(w for t, w in syncs if r.start <= t <= r.end) / 1e6,
            "mallocs": sum(r.start <= t <= r.end for t, _ in mallocs),
            "malloc_s": sum(w for t, w in mallocs if r.start <= t <= r.end) / 1e6,
            "device_s": sum(w for t, w in device if r.start <= t <= r.end) / 1e6,
            "by_part": {label.split("/", 1)[1]: v for label, v in by_part.items()
                        if label is not None and label.startswith(phase + "/")}}
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
