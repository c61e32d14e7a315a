"""The FRI fold kernel with its other twiddle source, built from this
checkout's csrc/fri_fold.cu by substitution and timed on one CUDA card
against the kernel as committed, at every fold step of three proves
(fib19_io at the default config, big22, fib19_io at production
parameters). The committed kernel reads the circle FFT's doubled int32
tables and inverts them in batches; the variant leaves out the inversion
and reads int32 inverse tables of their own (fri._fold_itw, built on the
card), and its output must equal the committed kernel's word for word.
Each time is the device time of 5 calls queued behind a sleep kernel.
Prints the card and one JSON line: for each step its outputs, both times,
each one's bytes bound and the bytes of the inverse tables it reads.

    python3 tools/fold_variants.py
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from unittest import mock

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stwo_brainfuck_tpu_torch import air  # noqa: E402
from stwo_brainfuck_tpu_torch.core import fri  # noqa: E402
from stwo_brainfuck_tpu_torch.ops import fri_kernels, nvcc  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine  # noqa: E402

INVERSION = "qm31::batch_inv<kK * kT>(z, tw);"


def _build(tmp: str) -> fri_kernels.FoldKernel:
    """The variant: csrc/fri_fold.cu without its twiddles' inversion."""
    src = (nvcc.CSRC / "fri_fold.cu").read_text()
    if src.count(INVERSION) != 1:
        raise RuntimeError(f"csrc/fri_fold.cu does not hold `{INVERSION}` once")
    for h in nvcc.CSRC.glob("*.cuh"):
        shutil.copy(h, tmp)
    path = os.path.join(tmp, "fri_fold.cu")
    with open(path, "w") as f:
        f.write(src.replace(INVERSION, ""))
    out = os.path.join(tmp, "lib.so")
    subprocess.run([nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-o", out, path], check=True)
    kernel = fri_kernels.FoldKernel()
    cdll = ctypes.CDLL(out)
    fri_kernels._bind(cdll)
    kernel.lib._lib = cdll
    return kernel


def _inverse_tables(kind, log, top, device):
    """fri.fold_twiddles' stand-in for the variant: the inverse table of
    the fold, read from its start."""
    return fri._fold_itw(kind, log, device), 0


def _bytes_ms(step, n: int, has_a: bool, has_b: bool) -> float:
    return chip_smoke.fold_work(step, n, has_a, has_b)[0] / chip_smoke.HBM_BYTES_PER_S * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("fold_variants: no CUDA device", file=sys.stderr)
        return 1
    real = fri.fold_step
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        variant = _build(tmp)
        for name, path, inp, config in (
                ("fib19_io", "programs/fib19_io.bf", chip_smoke.FIB_INPUT, None),
                ("big22", "programs/big22.bf", b"", None),
                ("production", "programs/fib19_io.bf", chip_smoke.FIB_INPUT,
                 chip_smoke.PRODUCTION)):
            rows = result[name] = []

            def hook(values, step, inject_a=None, inject_b=None, offset=0):
                got = real(values, step, inject_a, inject_b, offset)
                has = (inject_a is not None, inject_b is not None)
                with mock.patch.object(fri, "fold_twiddles", _inverse_tables):
                    other = variant.fold(values, step, inject_a, inject_b, offset)
                    if not torch.equal(other, got):
                        raise AssertionError(f"{name}: the inverse-table variant differs at "
                                             f"level {step.level}, {step.folds} folds")
                    tables = fri_kernels.twiddle_reads(step, got.shape[1], offset, *has,
                                                       values.device)
                    variant_ms = chip_smoke._time_ms(lambda: variant.fold(
                        values, step, inject_a, inject_b, offset), queued=True)
                rows.append({
                    "level": step.level, "folds": step.folds, "circle": step.circle,
                    "inject_a": has[0], "inject_b": has[1], "outputs": int(got.shape[1]),
                    "ms": chip_smoke._time_ms(lambda: real(values, step, inject_a, inject_b,
                                                           offset), queued=True),
                    "inverse_tables_ms": variant_ms,
                    "bytes_bound_ms": _bytes_ms(step, got.shape[1], *has),
                    "inverse_table_bytes": sum(int(t.numel()) * 4
                                               for t, _, _ in tables.values())})
                return got

            chip_smoke._clear_prover_caches()
            with open(os.path.join(os.getcwd(), path)) as f:
                machine = create_test_machine(compile_program(f.read()), inp)
            machine.execute()
            with mock.patch.object(fri, "fold_step", hook):
                air.prove_brainfuck(machine, config, device="cuda")
            chip_smoke._clear_prover_caches()
    print(chip_smoke._smi("name,power.limit"))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
