"""The decommitment's gather op on its first call in a process, for the
checkout of the current directory: each variant of core/merkle._take (the
op that reads one part of a gather into its slots of the flat buffer) in
a fresh process, that process's first fib19_io prove (input 19, default
config) and a second one, each with its decommit phase (air.PhaseTimer)
and the seconds of the decommitment's steps (each timed between two
synchronizations, so their sum exceeds the phase); then, in one more fresh
process each, the variant's first and second call alone on a (8, 2^20)
int32 tensor; and, first, the first and second call of each numpy
function core/merkle.Reads uses, in a fresh process.

    python3 tools/decommit_first_call.py

Card only. Prints the card and one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

VARIANTS = {
    "index_select": "torch.index_select(src.T, 0, columns, out=out)",
    "index_out": "torch.ops.aten.index.Tensor_out(src.T, [columns], out=out)",
    "index_then_copy": "out.copy_(src[:, columns].T)",
}

CHILD = r'''
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
from stwo_brainfuck_tpu_torch.core import merkle
exec("def _take(src, columns, out):\n    " + sys.argv[2])
merkle._take = _take
if sys.argv[1] == "host_ops":
    import itertools
    import numpy as np
    lists = [list(range(k, 80 + k)) for k in range(165)]
    ops = {
        "fromiter": lambda: np.fromiter(itertools.chain.from_iterable(lists), np.int64, 165 * 80),
        "cumsum": lambda: np.cumsum([80] * 165, dtype=np.int64),
        "flatnonzero": lambda: np.flatnonzero(np.arange(13200) % 7 == 0),
        "isin": lambda: np.isin(np.arange(50), np.arange(0, 13200, 80)),
        "searchsorted": lambda: np.searchsorted(np.arange(0, 13200, 80), np.arange(50), side="right"),
        "argsort": lambda: np.argsort(np.arange(80)[::-1], kind="stable"),
        "concatenate": lambda: np.concatenate([np.arange(80)] * 165),
    }
    res = {"numpy": np.__version__}
    for name, op in ops.items():
        times = []
        for _ in range(2):
            t = time.perf_counter()
            op()
            times.append(time.perf_counter() - t)
        res[name] = times
    print(json.dumps(res))
elif sys.argv[1] == "alone":
    src = torch.randint(0, 2**31 - 1, (8, 1 << 20), dtype=torch.int32, device="cuda")
    cols = torch.randint(0, 1 << 20, (64,), device="cuda")
    out = torch.empty((64, 8), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    times = []
    for _ in range(2):
        t = time.perf_counter()
        _take(src, cols, out)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    assert torch.equal(out, src[:, cols].T)
    print(json.dumps({"first_s": times[0], "second_s": times[1]}))
else:
    import chip_smoke
    from stwo_brainfuck_tpu_torch import air
    from stwo_brainfuck_tpu_torch.vm.compiler import compile_program
    from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine
    with open("programs/fib19_io.bf") as f:
        code = compile_program(f.read())
    steps = {}

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            steps[name] = steps.get(name, 0.0) + time.perf_counter() - t
            return out
        return run

    merkle._upload = timed("upload", merkle._upload)
    merkle._take = timed("take", merkle._take)
    merkle.pull = timed("pull", merkle.pull)
    merkle.Reads.__init__ = timed("reads", merkle.Reads.__init__)
    merkle.Reads.place = timed("place", merkle.Reads.place)
    merkle.PendingDecommitment.build = timed("build", merkle.PendingDecommitment.build)
    merkle.decommit_async = timed("decommit_async", merkle.decommit_async)
    res = {}
    for run in ("cold", "warm"):
        m = create_test_machine(code, chip_smoke.FIB_INPUT)
        m.execute()
        timer = air.PhaseTimer("cuda")
        steps.clear()
        proof = air.prove_brainfuck(m, device="cuda", timer=timer)
        res[run] = {"decommit_s": timer.seconds["decommit"], "steps_s": dict(steps),
                    "sha256": chip_smoke.proof_sha256(proof)}
    print(json.dumps(res))
'''


def _child(mode: str, body: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, mode, body], cwd=os.getcwd(),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    if not torch.cuda.is_available():
        print("decommit_first_call: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    result = {"host_ops": _child("host_ops", "pass")}
    for name, body in VARIANTS.items():
        result[name] = {"prove": _child("prove", body), "alone": _child("alone", body)}
    print(chip_smoke._smi("name,power.limit"))
    print(json.dumps({"checkout": os.getcwd(), "variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
