"""The proof-of-work grind kernel timed on one CUDA card at pow_bits 16, as
the prover calls it (one `blake2s_kernels.KERNELS.grind` call: its launches
and the 4-byte read of the answer), on the digest the small program's
pow_bits 16 prove grinds on and on GRIND_DIGESTS seeded digests. Each
nonce is checked against hashlib; each time is the mean of REPS whole
calls (CUDA events around calls that each end in a read of the answer).
Beside each: the bound of the work the search needs, (nonce + 1)
compressions at the card's compression rate (the `chain` probe on the full
card, measured here) plus one launch and 4-byte read (`launch_ms`, also
measured here).

    python3 <this checkout>/tools/grind_times.py

It times the `stwo_brainfuck_tpu_torch` package of the current directory,
so the same script times another checkout's grind (an older commit's
design) when started from that checkout's root. Prints the card and one
JSON line.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import subprocess
import sys
from unittest import mock

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stwo_brainfuck_tpu_torch import air  # noqa: E402
from stwo_brainfuck_tpu_torch.core.pcs import PcsConfig  # noqa: E402
from stwo_brainfuck_tpu_torch.ops import blake2s_kernels  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program  # noqa: E402
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine  # noqa: E402

SMALL_CODE, SMALL_INPUT = "+++>,<[>+.<-]", b"\x01"
POW_BITS = 16
GRIND_DIGESTS = 4
REPS = 20
CHAIN = 64


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _small_digest() -> bytes:
    """The digest the small program's prove at pow_bits 16 grinds on."""
    seen = []
    real = blake2s_kernels.KERNELS.grind
    machine = create_test_machine(compile_program(SMALL_CODE), SMALL_INPUT)
    machine.execute()
    with mock.patch.object(blake2s_kernels.KERNELS, "grind",
                           lambda d, bits, dev: seen.append(d) or real(d, bits, dev)):
        air.prove_brainfuck(machine, PcsConfig(log_max_rows=0, pow_bits=POW_BITS),
                            device="cuda")
    return seen[0]


def _hashlib_nonce(digest: bytes) -> int:
    nonce = 0
    while int.from_bytes(hashlib.blake2s(digest + struct.pack("<Q", nonce)).digest()[:4],
                         "little") & ((1 << POW_BITS) - 1):
        nonce += 1
    return nonce


def main() -> int:
    if not torch.cuda.is_available():
        print("grind_times: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    K = blake2s_kernels.KERNELS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = sms * 2048 * 4
    rate = n * CHAIN / (_ms(lambda: K.chain(n, CHAIN, "cuda"), 5) / 1e3)
    flag = torch.empty(1, dtype=torch.int32, device="cuda")
    launch_ms = _ms(lambda: flag.fill_(-1).item(), REPS)
    rng = np.random.default_rng(11)
    digests = [("small_pow16", _small_digest())] + [
        (f"digest {i}", rng.integers(0, 256, 32).astype(np.uint8).tobytes())
        for i in range(GRIND_DIGESTS)]
    out = {"checkout": os.getcwd(), "pow_bits": POW_BITS, "compressions_per_s": rate,
           "launch_ms": launch_ms, "grinds": {}}
    for name, digest in digests:
        nonce = K.grind(digest, POW_BITS, "cuda")
        if nonce != _hashlib_nonce(digest):
            raise AssertionError(f"{name}: grind {nonce} != hashlib")
        launches = K.launches["grind"]
        ms = _ms(lambda: K.grind(digest, POW_BITS, "cuda"), REPS)
        bound_ms = (nonce + 1) / rate * 1e3 + launch_ms
        out["grinds"][name] = {"nonce": nonce, "ms": ms,
                               "launches_a_call": (K.launches["grind"] - launches) / (REPS + 1),
                               "bound_ms": bound_ms, "share_of_bound": bound_ms / ms}
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
