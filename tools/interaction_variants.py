"""Design variants of the interaction kernel (the LogUp interaction trace of
a component in one launch), built from this checkout's csrc/ by
substitution and timed on one CUDA card against the kernel as committed,
at every component shape of a default fib19_io prove (memory 2^20,
instruction and processor 2^18, five at 2^16, five at 2^4 .. 2^6) and at
big22's processor 2^22, on seeded random columns and lookup elements:

- the rows whose norms one m31_inv inverts (constraints::kBatchRows 4 as
  committed, 2 and 1);
- the tiles: at least 8 or 32 rows a tile (logup_scan::kMinTileRows 16
  as committed), tiles for half the resident CTAs (twice the rows a
  tile) with up to 200 KB of sums on chip (kMaxOnChipBytes 96 KB as
  committed), and the older scan's plan of at most 64 tiles (128 rows a
  tile at 2^20, the sums in the scratch);
- the rows' sums kept in the scratch between the sweeps where they would
  fit on chip (plan's on-chip test made false);
- what it replaces on one device: the device work of the interaction
  trace in the checkout given by --parent (its own sources: the is_first
  fills, the table's copy, the logup launch, the head fill and the coset
  scan launch, as its wrappers made them), and this checkout's pair (the
  mesh's logup and scan wrappers on the same rows).

Each variant is also the coset scan of seeded (4, N) row sums (the
skeleton's other row source, csrc/logup_scan.cu) at every shape. Each
variant's Q_k, S and claimed sum must equal the committed kernel's word
for word (the parent's S and claimed sum too, and every variant's scan
the committed scan's); each time is the mean of REPS launches behind a
sleep kernel, twice. Prints the card, each
variant's registers and spills (ptxas) and one JSON line.

    python3 tools/interaction_variants.py [--parent DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES, ELEMENT_SIZES  # noqa: E402
from stwo_brainfuck_tpu_torch.framework import component as framework  # noqa: E402
from stwo_brainfuck_tpu_torch.ops import constraint_kernels as ck  # noqa: E402
from stwo_brainfuck_tpu_torch.ops import m31_kernels, nvcc  # noqa: E402
from stwo_brainfuck_tpu_torch.ops.staging import PinnedRing  # noqa: E402

P = 2**31 - 1
REPS = 5  # queued calls: fewer than ops/staging.py's SLOTS, so none waits
CLASSES = {c.name: c for c in COMPONENT_CLASSES}
SHAPES = [("memory", 20), ("instruction", 18), ("processor", 18), ("jump_if_not_zero", 16),
          ("plus_instruction", 16), ("minus_instruction", 16), ("left_instruction", 16),
          ("right_instruction", 16), ("program", 6), ("jump_if_zero", 6),
          ("output_instruction", 6), ("end_of_execution", 4), ("input_instruction", 4),
          ("processor", 22)]
# name -> [(file, pattern, replacement)]
VARIANTS = {
    "committed": [],
    "batch_2": [("constraint_kernel.cuh", r"kBatchRows = \d+;", "kBatchRows = 2;")],
    "batch_1": [("constraint_kernel.cuh", r"kBatchRows = \d+;", "kBatchRows = 1;")],
    "min_rows_8": [("logup_scan.cuh", r"kMinTileRows = \d+;", "kMinTileRows = 8;")],
    "min_rows_32": [("logup_scan.cuh", r"kMinTileRows = \d+;", "kMinTileRows = 32;")],
    "half_tiles_200k": [("logup_scan.cuh", r"tiles_for\(log_n, resident_tiles<Src, false>\(0\)\)",
                         "tiles_for(log_n, resident_tiles<Src, false>(0) / 2)"),
                        ("logup_scan.cuh", r"kMaxOnChipBytes = \d+ \* 1024;",
                         "kMaxOnChipBytes = 200 * 1024;")],
    "parent_tiles": [("logup_scan.cuh", r"tiles_for\(log_n, resident_tiles<Src, false>\(0\)\)",
                      "tiles_for(log_n, 64)")],
    "scratch": [("logup_scan.cuh", r"if \(smem <= ", "if (false && smem <= ")],
}


def _nvcc(src: str, out: str):
    return subprocess.Popen([nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-o", out, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _build(tmp: str, parent: str | None) -> tuple:
    procs = {}
    for name, subs in VARIANTS.items():
        d = os.path.join(tmp, name)
        shutil.copytree(nvcc.CSRC, d)
        for fname, pattern, repl in subs:
            path = os.path.join(d, fname)
            with open(path) as f:
                text = f.read()
            new = re.sub(pattern, repl, text)
            if new == text:
                raise RuntimeError(f"variant {name}: {pattern} not in {fname}")
            with open(path, "w") as f:
                f.write(new)
        for stem in ("constraints", "logup_scan"):
            out = os.path.join(d, f"{stem}.so")
            procs[f"{name}/{stem}"] = (_nvcc(os.path.join(d, f"{stem}.cu"), out), out)
    if parent:
        csrc = os.path.join(parent, "stwo_brainfuck_tpu_torch", "csrc")
        for stem in ("constraints", "logup_scan"):
            out = os.path.join(tmp, f"parent_{stem}.so")
            procs[f"parent_{stem}"] = (_nvcc(os.path.join(csrc, f"{stem}.cu"), out), out)
    libs, regs = {}, {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        # ptxas: registers and spills of each kernel (coset_scan_kernel, logup_kernel)
        regs[name] = [line.strip() for line in log.splitlines()
                      if "registers" in line or "spill" in line][:80]
        libs[name] = ctypes.CDLL(out)
        if name.endswith("/constraints"):
            ck._bind(libs[name])
        elif name.endswith("/logup_scan"):
            ck._bind_scan(libs[name])
    return libs, regs


def _case(name: str, log: int, dev) -> tuple:
    rng = np.random.default_rng(log * 31 + len(name))
    comp = CLASSES[name](log)
    main = {c: torch.as_tensor(rng.integers(0, P, 1 << log).astype(np.int32), device=dev)
            for c in comp.columns}

    def felt():
        return tuple(int(v) for v in rng.integers(0, P, 4))

    els = {k: framework.LookupElements(z=felt(), alpha=felt(), size=s)
           for k, s in ELEMENT_SIZES.items()}
    return comp, main, els


def _parent_pair(libs: dict, comp, main: dict, els: dict, dev):
    """The device work of the parent's build_interaction_trace_async on the
    same rows, as its wrappers made it: the is_first column (two fills),
    the logup launch's table (one copy from a pinned ring), the logup
    launch, the scan's head (a fill) and the coset scan launch."""
    lib, scan = libs["parent_constraints"], libs["parent_logup_scan"]
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.constraints_logup.argtypes = [i32, ptr, i32, i32, i64, ptr, ptr, ptr]
    scan.logup_scan_scratch.argtypes = [i32, i64, ptr]
    scan.logup_scan_coset.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ptr]  # with a head
    n = 1 << comp.log_size
    words = ck.pack_constants(els)
    k = comp.relation_count()
    sizes = (ctypes.c_longlong * 2)()
    if scan.logup_scan_scratch(1, n, ctypes.addressof(sizes)) != 0:
        raise RuntimeError("parent scan: no scratch")
    cid = ck.COMPONENT_IDS[comp.name]
    ring = PinnedRing()
    out = {}

    isf = torch.empty(n, dtype=torch.int32, device=dev)
    rows = [main[c] for c in comp.columns] + [isf]
    host = ck.pack_table([r.data_ptr() for r in rows], words)

    def go():
        stream = torch.cuda.current_stream().cuda_stream
        isf.zero_()
        isf[:1].fill_(1)
        table = ring.to_card(host, dev)
        q = torch.empty((k, 4, n), dtype=torch.int32, device=dev)
        total = torch.empty((4, n), dtype=torch.int32, device=dev)
        if lib.constraints_logup(cid, table.data_ptr(), len(rows), words.size, n, q.data_ptr(),
                                 total.data_ptr(), stream) != 0:
            raise RuntimeError("parent logup launch failed")
        s = torch.empty((4, n), dtype=torch.int32, device=dev)
        claimed = torch.empty(4, dtype=torch.int32, device=dev)
        head = torch.zeros(sizes[0], dtype=torch.int32, device=dev)
        work = torch.empty(sizes[1], dtype=torch.int32, device=dev)
        if scan.logup_scan_coset(total.data_ptr(), s.data_ptr(), claimed.data_ptr(),
                                 head.data_ptr(), work.data_ptr(), comp.log_size, stream) != 0:
            raise RuntimeError("parent scan launch failed")
        out["got"] = (q, s, claimed)
    return go, out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an older checkout whose logup + scan pair to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("interaction_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    K = ck.KERNELS
    tmp = tempfile.mkdtemp()
    try:
        nvcc.build_all([m31_kernels.KERNELS.lib])  # its SASS sets the bound's product cost
        libs, regs = _build(tmp, args.parent)
        committed, committed_scan = K.lib.load(), K.scan_lib.load()
        per_mul, dispatch = chip_smoke.sass_per_mul()["per_mul"], _dispatch_per_s()
        times, plans = {}, {}
        for name, log in SHAPES:
            comp, main, els = _case(name, log, dev)
            total = torch.as_tensor(np.random.default_rng(log).integers(0, P, (4, 1 << log))
                                    .astype(np.int32), device=dev)
            shape = f"{name} 2^{log}"
            want = want_scan = None
            row = times.setdefault(shape, {})
            scan_key = f"coset scan 2^{log}"
            scan_row = None if scan_key in times else times.setdefault(scan_key, {})
            for variant in VARIANTS:
                K.lib._lib = libs[f"{variant}/constraints"]
                K.scan_lib._lib = libs[f"{variant}/logup_scan"]
                K._plans.clear()
                got = K.interaction(comp, main, els)
                got_scan = K.scan(total) if scan_row is not None else ()
                torch.cuda.synchronize()
                if want is None:
                    want, want_scan = got, got_scan
                elif not (all(torch.equal(g, w) for g, w in zip(got, want))
                          and all(torch.equal(g, w) for g, w in zip(got_scan, want_scan))):
                    raise AssertionError(f"variant {variant} != committed at {shape}")
                plans.setdefault(shape, {})[variant] = K.geometry(type(comp), log, dev)
                row[variant] = [chip_smoke._time_ms(lambda: K.interaction(comp, main, els),
                                                    REPS, queued=True) for _ in range(2)]
                if scan_row is not None:
                    plans.setdefault(scan_key, {})[variant] = K.geometry("scan", log, dev)
                    scan_row[variant] = [chip_smoke._time_ms(lambda: K.scan(total), REPS,
                                                             queued=True) for _ in range(2)]
            K.lib._lib, K.scan_lib._lib = committed, committed_scan
            K._plans.clear()
            isf = torch.zeros(1 << log, dtype=torch.int32, device=dev)
            isf[0] = 1

            def pair():
                _, total = K.logup(comp, main, isf, els)
                K.scan(total)
            row["pair"] = [chip_smoke._time_ms(pair, REPS, queued=True) for _ in range(2)]
            if args.parent:
                go, out = _parent_pair(libs, comp, main, els, dev)
                go()
                torch.cuda.synchronize()
                q, s, claimed = out["got"]
                if not (torch.equal(q, want[0]) and torch.equal(s, want[1])
                        and torch.equal(claimed, want[2])):
                    raise AssertionError(f"the parent's pair != the interaction kernel at {shape}")
                row["parent_pair"] = [chip_smoke._time_ms(go, REPS, queued=True)
                                      for _ in range(2)]
            row["bound"] = chip_smoke._constraint_bound(comp, "interaction", 1 << log, per_mul,
                                                        dispatch)
            del main, want, total, want_scan
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(chip_smoke._smi("name,power.limit"))
    for name, lines in regs.items():
        print(name, lines)
    print(json.dumps({"variants": {k: [s[0] + " -> " + s[2] for s in v]
                                   for k, v in VARIANTS.items()},
                      "reps": REPS, "plans": plans, "times_ms": times}))
    return 0


def _dispatch_per_s() -> float:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(chip_smoke._smi("clocks.max.sm").split()[0])
    return sms * 4 * 32 * max_mhz * 1e6


if __name__ == "__main__":
    sys.exit(main())
