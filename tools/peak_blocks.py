"""The device memory at the peak of one cold production prove of fib19_io
(input 19, PcsConfig(log_blowup=4, n_queries=30, pow_bits=16)) on one
CUDA card, for the checkout of the current directory, in a fresh process
(or of another program or config, or a warm prove, as the options say):

- the allocator's peak allocated bytes (torch.cuda.max_memory_allocated,
  the peaks PERF.md records) beside its peak requested bytes (the
  tensors' own sizes, before the allocator rounds a request up to its
  block or hands out a cached block whole);
- every block live at the peak of the allocator's trace, replayed
  (chip_smoke._blocks_at_peak), summed by allocation site (the innermost
  frames inside the package);
- at the end of each prover phase (air.PhaseTimer's marks): the
  allocated and requested bytes live and each phase's peaks of both, and
  every live block that the allocator handed out at least OVERSIZE bytes
  larger than its request (a cached block it did not split), with its
  site.

    python3 <this checkout>/tools/peak_blocks.py [--program big22] [--default] [--warm]

--program big22 proves programs/big22.bf (no input); --default proves at
the prover's default config; --warm proves once first and empties the
allocator's cache, as chip_smoke.py does between its proves, and reads the
second prove.

Started from another checkout's root (an older commit unpacked) it reads
that commit's prover, so parent and change compare in one call. Prints the
card and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stwo_brainfuck_tpu_torch import air  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine  # noqa: E402

EVENTS = 500_000
FRAMES = 3
OVERSIZE = 4096


def _site(ev: dict) -> str:
    """The block's allocation site: its innermost FRAMES frames inside the
    package, innermost first."""
    out = []
    for fr in ev.get("frames", []):
        name = fr.get("filename", "")
        if "stwo_brainfuck_tpu_torch" in name:
            out.append(f"{os.path.relpath(name, os.getcwd())}:{fr.get('line')} {fr.get('name')}")
        if len(out) == FRAMES:
            break
    return " < ".join(out) or "outside the package"


class _MemoryTimer(air.PhaseTimer):
    """A PhaseTimer that reads the allocator at each mark (after the
    mark's synchronization) and resets its peaks."""

    def __init__(self, device):
        super().__init__(device)
        self.memory: dict = {}
        torch.cuda.reset_peak_memory_stats()

    def mark(self, name: str) -> None:
        super().mark(name)
        stats = torch.cuda.memory_stats()
        oversized = []
        for seg in torch.cuda.memory_snapshot():
            for b in seg["blocks"]:
                if (b["state"] == "active_allocated"
                        and b["size"] - b.get("requested_size", b["size"]) >= OVERSIZE):
                    oversized.append([_site(b), b["size"], b["requested_size"]])
        self.memory[name] = {
            "allocated": stats["allocated_bytes.all.current"],
            "requested": stats.get("requested_bytes.all.current"),
            "allocated_peak": stats["allocated_bytes.all.peak"],
            "requested_peak": stats.get("requested_bytes.all.peak"),
            "oversized": oversized}
        torch.cuda.reset_peak_memory_stats()


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="peak_blocks.py")
    ap.add_argument("--program", choices=["fib19_io", "big22"], default="fib19_io")
    ap.add_argument("--default", action="store_true")
    ap.add_argument("--warm", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("peak_blocks: no CUDA device", file=sys.stderr)
        return 1
    config = None if args.default else chip_smoke.PRODUCTION
    inp = chip_smoke.FIB_INPUT if args.program == "fib19_io" else b""
    with open(os.path.join(os.getcwd(), "programs", f"{args.program}.bf")) as f:
        code = compile_program(f.read())
    if args.warm:
        machine = create_test_machine(code, inp)
        machine.execute()
        air.prove_brainfuck(machine, config, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    machine = create_test_machine(code, inp)
    machine.execute()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(enabled="all", context="alloc", stacks="python",
                                             max_entries=EVENTS)
    timer = _MemoryTimer("cuda")
    proof = air.prove_brainfuck(machine, config, device="cuda", timer=timer)
    torch.cuda.synchronize()
    snapshot = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    trace = snapshot["device_traces"][torch.cuda.current_device()]
    trace_peak, blocks, _ = chip_smoke._blocks_at_peak(trace)
    sites: dict = {}
    for ev in blocks:
        count_bytes = sites.setdefault(_site(ev), [0, 0])
        count_bytes[0] += 1
        count_bytes[1] += ev["size"]
    print(chip_smoke._smi("name,power.limit"))
    print(json.dumps({
        "checkout": os.getcwd(), "program": args.program,
        "config": "default" if args.default else "production", "warm": args.warm,
        "sha256": chip_smoke.proof_sha256(proof),
        "allocated_peak": max(m["allocated_peak"] for m in timer.memory.values()),
        "requested_peak": max(m["requested_peak"] for m in timer.memory.values()),
        "phases": timer.memory,
        "trace_events": len(trace), "trace_peak": trace_peak, "blocks_at_peak": len(blocks),
        "sites_at_peak": {k: v for k, v in sorted(sites.items(), key=lambda kv: -kv[1][1])}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
