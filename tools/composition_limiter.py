"""What limits the composition kernel, read on one CUDA card without a
profiler, for the checkout it is started from:

- each prove's whole composition (a default fib19_io prove, big22, and
  fib19_io at production parameters, input 19), on the prove's own inputs
  recorded by patching the kernel's entry: the one launch a prove (or, in
  a checkout whose prover launches the kernel once a component, the sum of
  its 13 launches, each timed on its own);
- the processor component at big22's shape (2^22 rows, blowup 1: 2^23
  rows) on seeded inputs, as the prover launches it (S(p - g) through the
  rotation index) and with S(p - g) given as rows;
- in a one-launch checkout, the same with each variant of VARIANTS built
  by substitution (the product policy m31::Product in place of
  csrc/constraint_kernel.cuh's CompositionProduct m31::Doubled; launch
  bounds without the 4 blocks an SM, so as many registers as the bodies
  take; the weighted sums reduced to canonical words between runs of
  products in place of folded below 2^34), their outputs word for word
  the committed build's, each prove's launch timed in two rounds (the
  second in the reverse order);
- registers, spills and SASS instructions of the kernels (cuobjdump): the
  one-launch kernel and its processor-only probe (composition_probe_processor),
  or the per-component kernels, with the probe's (or the processor
  kernel's) opcode counts.

Each time is the mean of REPS launches queued behind a sleep kernel, beside
the bound of the same work whatever computes it
(constraint_kernels.composition_work: each input read once, each
accumulator written once; the products' issue at the measured SASS of
m31::mul) where the checkout has it.

    python3 tools/composition_limiter.py

Prints the card and one JSON line. Start it from an older checkout's root
(python3 <this checkout>/tools/composition_limiter.py) to read that one.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from unittest import mock

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stwo_brainfuck_tpu_torch import air  # noqa: E402
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES  # noqa: E402
from stwo_brainfuck_tpu_torch.core import fft  # noqa: E402
from stwo_brainfuck_tpu_torch.framework import component as framework  # noqa: E402
from stwo_brainfuck_tpu_torch.ops import (  # noqa: E402
    blake2s_kernels, circle_fft, constraint_kernels, fri_kernels, m31_kernels, nvcc, oods_kernels,
    quotient_kernels, table_kernels)
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine  # noqa: E402

LOG, BLOWUP = 22, 1
REPS = 5
ONE_LAUNCH = hasattr(framework, "composition_evaluate")
PROVES = (("fib19_io", "programs/fib19_io.bf", chip_smoke.FIB_INPUT, None),
          ("big22", "programs/big22.bf", b"", None),
          ("production", "programs/fib19_io.bf", chip_smoke.FIB_INPUT, chip_smoke.PRODUCTION))


def _resources(lib_path: str, tag: str) -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-res-usage", lib_path], capture_output=True, text=True,
                         check=True).stdout
    out = {}
    for name, regs, rest in re.findall(r"Function (\S+):\s*REG:(\d+)(.*)", res):
        if re.search(tag, name):
            spill = re.search(r"LOCAL:(\d+)", rest)
            out[name] = {"registers": int(regs), "local_bytes": int(spill.group(1)) if spill
                         else None}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if m.group(1) in out else None
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and op and op.group(1) != "NOP":
            out[name]["instructions"] = out[name].get("instructions", 0) + 1
            if re.search("probe|Processor", name):
                ops = out[name].setdefault("ops", {})
                ops[op.group(1)] = ops.get(op.group(1), 0) + 1
    for v in out.values():
        if "ops" in v:
            v["ops"] = dict(sorted(v["ops"].items(), key=lambda kv: -kv[1]))
    return out


# variants of the committed library, built by substitution: (file, committed
# text, variant text) each
VARIANTS = {
    "product": [("constraint_kernel.cuh", "using CompositionProduct = m31::Doubled;",
                 "using CompositionProduct = m31::Product;")],
    "blocks3": [("constraint_kernel.cuh", "__launch_bounds__(kThreads, 4) composition_kernel(",
                 "__launch_bounds__(kThreads) composition_kernel(")],
    "reduce64": [("constraints.cu", "x = m31::fold64(x);", "x = m31::reduce64(x);")],
}


def _variants(tmp: str) -> dict:
    """name -> (a ConstraintKernels on the variant's library, its path),
    every variant's nvcc started together."""
    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for f in nvcc.CSRC.glob("*.cu*"):
            shutil.copy(f, d)
        for file, old, new in subs:
            path = os.path.join(d, file)
            with open(path) as f:
                text = f.read()
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {file}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        out = os.path.join(d, "lib.so")
        procs[name] = (subprocess.Popen([nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-o", out,
                                         os.path.join(d, "constraints.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    built = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} does not build:\n{log[-3000:]}")
        kernels = constraint_kernels.ConstraintKernels()
        cdll = ctypes.CDLL(out)
        constraint_kernels._bind(cdll)
        kernels.lib._lib = cdll
        built[name] = (kernels, out)
    return built


def _bound(spec, blow, per_mul, dispatch_per_s) -> dict:
    if not ONE_LAUNCH:
        return {}
    return chip_smoke._composition_bound(spec, blow, per_mul, dispatch_per_s)


def _prove_inputs(name, path, inp, config) -> list:
    """The composition calls of one prove, their arguments as the prover
    gave them."""
    K = constraint_kernels.KERNELS
    real, seen = K.composition, []

    def hook(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    with open(os.path.join(os.getcwd(), path)) as f:
        machine = create_test_machine(compile_program(f.read()), inp)
    machine.execute()
    with mock.patch.object(K, "composition", hook):
        air.prove_brainfuck(machine, config, device="cuda")
    return seen


def _processor_case(log: int) -> tuple:
    comp = next(c for c in COMPONENT_CLASSES if c.name == "processor")(log)
    program = framework.constraint_program(type(comp))
    m = 1 << (log + BLOWUP)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    rng = np.random.default_rng(22)
    main = dict(zip(comp.columns, chip_smoke._rows_like(gen, len(comp.columns), m, dev, False)))
    inter = chip_smoke._rows_like(gen, 4 * (len(program.relations) + 1), m, dev, False)
    is_first = chip_smoke._rows_like(gen, 1, m, dev, False)[0]
    rot = fft.rotation_index(log, BLOWUP, dev)
    s_prev = [r[rot.to(torch.int64)].contiguous() for r in inter[-4:]]
    acc = torch.stack(chip_smoke._rows_like(gen, 4, m, dev, False))
    return (comp, main, inter, is_first, rot, s_prev, acc, chip_smoke._felt(rng),
            chip_smoke._felt(rng), chip_smoke._elements(rng), m)


def main() -> int:
    if not torch.cuda.is_available():
        print("composition_limiter: no CUDA device", file=sys.stderr)
        return 1
    kernels = constraint_kernels.KERNELS
    nvcc.build_all([circle_fft.KERNEL.lib, m31_kernels.KERNELS.lib, blake2s_kernels.KERNELS.lib,
                    quotient_kernels.KERNEL.lib, kernels.lib, kernels.scan_lib,
                    oods_kernels.KERNEL.lib, fri_kernels.KERNEL.lib, table_kernels.KERNEL.lib])
    per_mul = chip_smoke.sass_per_mul()["per_mul"]
    max_mhz = float(chip_smoke._smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dispatch_per_s = sms * 4 * 32 * max_mhz * 1e6
    out = {"one_launch": ONE_LAUNCH, "per_mul": per_mul, "reps": REPS}
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"committed": kernels}
        if ONE_LAUNCH:
            out["variants"] = {k: [sub[2] for sub in v] for k, v in VARIANTS.items()}
            out["kernels"] = {"committed": _resources(str(kernels.lib.path()), "composition")}
            for name, (k, path) in _variants(tmp).items():
                builds[name] = k
                out["kernels"][name] = _resources(path, "composition")
        else:
            out["kernels"] = {"committed": _resources(str(kernels.lib.path()), "Processor")}
        # the processor at 2^22, blowup 1
        out["processor"] = {}
        for log in (LOG,):
            (comp, main_cols, inter, is_first, rot, s_prev, acc, claimed, alpha, els,
             m) = _processor_case(log)
            times = {}
            for name, rows, rotation in (("as the prover", inter[-4:], rot),
                                         ("S(p - g) as rows", s_prev, None)):
                if ONE_LAUNCH:
                    seg = framework.CompositionSegment(log, [framework.CompositionMember(
                        comp, main_cols, inter, rows, claimed, 0)], is_first, rotation)
                    spec = [(log, m, [comp], rotation is not None)]
                    results = {b: k.composition([seg], els, alpha, BLOWUP)[0]
                               for b, k in builds.items()}
                    for b, r in results.items():
                        if not torch.equal(r, results["committed"]):
                            raise AssertionError(f"variant {b}: the composition differs")
                    times[name] = {b: chip_smoke._time_ms(
                        lambda k=k: k.composition([seg], els, alpha, BLOWUP), reps=REPS,
                        queued=True) for b, k in builds.items()}
                    times[name].update(_bound(spec, BLOWUP, per_mul, dispatch_per_s))
                else:
                    times[name] = {"committed": chip_smoke._time_ms(
                        lambda rows=rows, rotation=rotation: kernels.composition(
                            comp, main_cols, inter, rows, rotation, is_first, claimed, els,
                            alpha, 0, BLOWUP, acc), reps=REPS, queued=True)}
            out["processor"][f"2^{log}"] = {"log_size": log, "log_blowup": BLOWUP, "rows": m,
                                           "times": times}
            del main_cols, inter, is_first, s_prev, acc
            torch.cuda.empty_cache()
        # each prove's composition on its own inputs
        out["proves"] = {}
        for name, path, inp, config in PROVES:
            calls = _prove_inputs(name, path, inp, config)
            entry = {"launches": len(calls)}
            if ONE_LAUNCH:
                (segments, e, a, blow), _ = calls[0]
                spec = [(s.log_size, s.is_first.shape[0], [x.component for x in s.members],
                         s.rotation is not None) for s in segments]
                want = kernels.composition(segments, e, a, blow)
                for b, k in builds.items():
                    got = k.composition(segments, e, a, blow)
                    if not all(torch.equal(x, y) for x, y in zip(got, want)):
                        raise AssertionError(f"{name}: variant {b}'s composition differs")
                # two rounds, the second in the reverse order
                for b, k in [*builds.items(), *reversed(builds.items())]:
                    entry.setdefault(b, []).append(chip_smoke._time_ms(
                        lambda k=k: k.composition(segments, e, a, blow), reps=REPS,
                        queued=True))
                entry["segments"] = [[n, rows, [c.name for c in cs]] for n, rows, cs, _ in spec]
                entry.update(_bound(spec, blow, per_mul, dispatch_per_s))
            else:  # each launch on its own (the host part of 13 calls outlasts the sleep)
                per = [chip_smoke._time_ms(lambda args=args, kw=kw: kernels.composition(
                    *args, **kw), reps=REPS, queued=True) for args, kw in calls]
                entry["committed"] = sum(per)
                entry["each"] = per
            out["proves"][name] = entry
            del calls
            chip_smoke._clear_prover_caches()
            torch.cuda.empty_cache()
    print(chip_smoke._smi("name,power.limit"))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
