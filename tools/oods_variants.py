"""Design variants of the OODS kernel, built from this checkout's
csrc/oods.cu by substitution and timed on one CUDA card against the
kernel as committed, on the OODS launch of three proves (fib19_io at the
default config, big22, fib19_io at production parameters; the groups as
the prove gives them): the positions a block takes (2^TILE, its rows a
thread at W = 256: 2^(TILE - 8)). Each variant's output must equal the
committed kernel's word for word; each time is the device time of REPS
launches back to back on a table packed once (the host's packing left
out), twice. Prints the card, each variant's registers and shared memory
(ptxas) and one JSON line.

    python3 tools/oods_variants.py
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

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stwo_brainfuck_tpu_torch import air  # noqa: E402
from stwo_brainfuck_tpu_torch.core import poly  # noqa: E402
from stwo_brainfuck_tpu_torch.ops import nvcc, oods_kernels  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine  # noqa: E402

REPS = 20
# name -> log2 of the positions a block takes
VARIANTS = {f"tile{t}": t for t in (13, 14, 15, 16)}


def _build(tmp: str) -> dict:
    src = (nvcc.CSRC / "oods.cu").read_text()
    procs = {}
    for name, tile in VARIANTS.items():
        text = re.sub(r"kTileLog = \d+;", f"kTileLog = {tile};", src)
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for h in nvcc.CSRC.glob("*.cuh"):
            shutil.copy(h, d)
        with open(os.path.join(d, "oods.cu"), "w") as f:
            f.write(text)
        out = os.path.join(d, "lib.so")
        procs[name] = (subprocess.Popen([nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-o", out,
                                         os.path.join(d, "oods.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        kernel = oods_kernels.OodsKernel()
        cdll = ctypes.CDLL(out)
        with mock.patch.object(oods_kernels, "TILE_LOG", VARIANTS[name]):
            oods_kernels._bind(cdll)
        kernel.lib._lib = cdll
        libs[name] = (kernel, " ".join(re.findall(r"Used \d+ registers.*", log)))
    return libs


def _launch_groups() -> dict:
    """The groups of the OODS launch of each of the three proves."""
    real = poly.sample_groups
    out = {}
    for name, path, inp, config in (
            ("fib19_io", "programs/fib19_io.bf", chip_smoke.FIB_INPUT, None),
            ("big22", "programs/big22.bf", b"", None),
            ("production", "programs/fib19_io.bf", chip_smoke.FIB_INPUT, chip_smoke.PRODUCTION)):
        seen = []

        def hook(groups, shard=0):
            seen.append(groups)
            return real(groups, shard)

        with open(os.path.join(os.getcwd(), path)) as f:
            machine = create_test_machine(compile_program(f.read()), inp)
        machine.execute()
        with mock.patch.object(poly, "sample_groups", hook):
            air.prove_brainfuck(machine, config, device="cuda")
        out[name] = seen[0]
        chip_smoke._clear_prover_caches()  # the groups' rows stay alive through `seen`
    return out


def _device_ms(kernel, groups, want) -> list:
    """chip_smoke.oods_device_ms of REPS launches, twice."""
    return [chip_smoke.oods_device_ms(kernel, groups, want, reps=REPS) for _ in range(2)]


def main() -> int:
    if not torch.cuda.is_available():
        print("oods_variants: no CUDA device", file=sys.stderr)
        return 1
    launches = _launch_groups()
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(tmp)
        for prove, groups in launches.items():
            want = oods_kernels.KERNEL.sample(groups)
            nbytes, _ = chip_smoke.oods_work(groups)
            row = {"bytes_bound_ms": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3,
                   "committed_ms": _device_ms(oods_kernels.KERNEL, groups, want)}
            for name, (kernel, _) in libs.items():
                with mock.patch.object(oods_kernels, "TILE_LOG", VARIANTS[name]):
                    row[name] = _device_ms(kernel, groups, want)
            result[prove] = row
    print(chip_smoke._smi("name,power.limit"))
    for name, (_, ptxas) in libs.items():
        print(name, ptxas)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
