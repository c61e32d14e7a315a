"""The mesh path's elementwise M31 stages on one card (card only).

    python3 tools/mesh_stage_times.py [--log 28] [--rows 4] [--repeats 5]

Times each stage of ``ops/mesh_kernels`` (the evaluate's and the
interpolate's cross stages, the interpolate's last stage with the 2^-n
folded in, the composition's sum) on a (rows, 2^log) int32 shard in place,
one launch a column as the sharded FFT makes them, with CUDA events (best
of `repeats` after one warm run), beside the byte bound (12 bytes a
position: the shard and the partner's column read, the shard written, at
3.35 TB/s) and the plain int64 torch form of the same stage on the whole
shard at once (as the sharded FFT ran it before the kernel), with each
form's allocator peak above its inputs. Every kernel result is
checked against the plain form. Prints the card and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

from stwo_brainfuck_tpu_torch.core import fft, m31  # noqa: E402
from stwo_brainfuck_tpu_torch.ops import mesh_kernels  # noqa: E402

P = m31.P_INT
PEAK_BYTES_PER_S = 3.35e12


def _plain(stage: str, x, y, t, s):
    if stage == "evaluate_lower":
        return m31.add(x, m31.mul(y, t)).to(torch.int32)
    if stage == "evaluate_upper":
        return m31.sub(y, m31.mul(x, t)).to(torch.int32)
    if stage == "interpolate_lower":
        return m31.add(x, y).to(torch.int32)
    if stage == "interpolate_last_lower":
        return m31.mul(m31.add(x, y), s).to(torch.int32)
    if stage == "interpolate_upper":
        return m31.mul(m31.sub(y, x), t).to(torch.int32)
    return ((x.to(torch.int64) + y) % P).to(torch.int32)


def _kernel(stage: str, col, ycol, t, s):
    if stage.startswith("evaluate"):
        mesh_kernels.evaluate_cross(col, ycol, t, stage.endswith("upper"))
    elif stage == "add":
        mesh_kernels.add_into(col, ycol)
    else:
        mesh_kernels.interpolate_cross(col, ycol, t, stage.endswith("upper"),
                                       scale=s if "last" in stage else 1)


def _time(fn, repeats: int) -> float:
    fn()
    best = None
    for _ in range(repeats):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b)
        best = ms if best is None else min(best, ms)
    return best


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="mesh_stage_times.py")
    ap.add_argument("--log", type=int, default=28)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mesh_stage_times: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    n = 1 << args.log
    g = torch.Generator(device=dev).manual_seed(args.log)
    x = torch.randint(0, P, (args.rows, n), dtype=torch.int32, device=dev, generator=g)
    y = torch.randint(0, P, (args.rows, n), dtype=torch.int32, device=dev, generator=g)
    t, s = 1234567891 % P, fft.inv_pow2(args.log + 2)
    bound_ms = 12 * args.rows * n / PEAK_BYTES_PER_S * 1e3
    out = {"card": card, "shape": [args.rows, n], "bound_ms": bound_ms, "stages": {}}
    for stage in ("evaluate_lower", "evaluate_upper", "interpolate_lower",
                  "interpolate_last_lower", "interpolate_upper", "add"):
        want = _plain(stage, x, y, t, s)
        got = x.clone()
        for j in range(args.rows):
            _kernel(stage, got[j], y[j], t, s)
        if not torch.equal(got, want):
            raise AssertionError(f"{stage}: the kernel differs from the plain form")
        del want, got
        work = x.clone()

        def kernel():
            for j in range(args.rows):
                _kernel(stage, work[j], y[j], t, s)

        def plain():  # the whole shard at once, as the int64 form ran
            work.copy_(_plain(stage, work, y, t, s))

        torch.cuda.synchronize()
        peaks = {}
        for name, fn in (("kernel", kernel), ("plain", plain)):
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() - base
        k_ms, p_ms = _time(kernel, args.repeats), _time(plain, args.repeats)
        out["stages"][stage] = {"kernel_ms": k_ms, "plain_ms": p_ms,
                                "share_of_bound": bound_ms / k_ms,
                                "kernel_peak_bytes": peaks["kernel"],
                                "plain_peak_bytes": peaks["plain"]}
        del work
    out["launches"] = mesh_kernels.KERNEL.launches
    out["plain_cuda_calls"] = mesh_kernels.PLAIN_CUDA_CALLS
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
