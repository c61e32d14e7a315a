"""Where a warm fib19_io prove's time goes, for the checkout of the current
directory: its kernels built, two warm-up proves of fib19_io (input 19),
then one profiled prove (chip_smoke.phase_split of that checkout: the
device-busy share, the host synchronizations and their wait, device events
and kernels, the kernels that take the most device time; default config
only), one more profiled prove split inside its `oods` and `fri` phases,
and the phases of one more prove (air.PhaseTimer, each mark
synchronizing).

    python3 <this checkout>/tools/split_times.py [--production]

--production proves at chip_smoke.PRODUCTION (fib19_io at input 19,
committed at 2^28). The split inside `oods` and `fri` times the prover's
own functions as profiler ranges, each the host time of its calls less the
ranges inside it: `oods` into its bases or launch table
(poly.half_bases_at_point; ops/oods_kernels.pack, the factor table of the
first OODS kernel; ops/oods_kernels.plan, the table of the persistent one),
its contraction (poly.sample_tensor, or the OODS kernel's call less its
table) and its pull (poly.pull);
`fri` into its folds (fri._fold, or fri.fold_step), its layer commits
(merkle.commit) and their root pulls (blake2s.digest_to_bytes); what no
range covers is `other`. Beside them, in each phase: its device->host
copies, host syncs and their wait, and the device time of the kernels and
copies that start in it. A function the checkout lacks is left out, so
started from another checkout's root (an older commit unpacked) it reads
that commit's prover: parent and change compare in one call. Prints the
card and one JSON line.
"""

from __future__ import annotations

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
# (phase, part) -> the functions timed as that part, where the checkout has them
PARTS = {
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


def _inside_split(code, inp: bytes, config) -> dict:
    """One profiled prove: the host seconds of each PARTS range less the
    ranges inside it, within the `oods` and `fri` phases."""
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
    ranges, parts, device, syncs, dtoh = {}, [], [], [], []
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
    out = {}
    for phase in ("oods", "fri"):
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
            "device_s": sum(w for t, w in device if r.start <= t <= r.end) / 1e6}
    return out


def main(argv) -> int:
    if argv not in ([], ["--production"]):
        print(f"usage: {sys.argv[0]} [--production]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("split_times: no CUDA device", file=sys.stderr)
        return 1
    config = chip_smoke.PRODUCTION if argv else None
    path = os.path.join(os.getcwd(), "programs", "fib19_io.bf")
    with open(path) as f:
        code = compile_program(f.read())
    for _ in range(WARM_UP):
        m = create_test_machine(code, chip_smoke.FIB_INPUT)
        m.execute()
        air.prove_brainfuck(m, config, device="cuda")
    torch.cuda.synchronize()
    split = None
    if config is None:
        with contextlib.redirect_stdout(io.StringIO()):
            split = chip_smoke.phase_split("fib19_io", path, chip_smoke.FIB_INPUT)
    inside = _inside_split(code, chip_smoke.FIB_INPUT, config)
    m = create_test_machine(code, chip_smoke.FIB_INPUT)
    m.execute()
    timer = air.PhaseTimer("cuda")
    torch.cuda.reset_peak_memory_stats()
    air.prove_brainfuck(m, config, device="cuda", timer=timer)
    torch.cuda.synchronize()
    print(chip_smoke._smi("name,power.limit"))
    print(json.dumps({"checkout": os.getcwd(), "config": "production" if config else "default",
                      "phase_split": split, "inside": inside, "phases_s": timer.seconds,
                      "peak_device_bytes": torch.cuda.max_memory_allocated()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
