"""Whole Blake2s Merkle trees timed on one CUDA card, as the prover commits
them: the 2^20-leaf FRI layer tree and every tree signature of a fib19_io
prove (random words at each signature's shapes), each as device time (ten
`merkle.hash_levels` calls queued behind a sleep kernel) and call time (ten
`merkle.commit(...).root` calls back to back, the root read back each time).

    python3 <this checkout>/tools/blake2s_trees.py [--schedules]

It times the `stwo_brainfuck_tpu_torch` package and `chip_smoke.py` of the
current directory, so the same script times another checkout (an older
commit's Merkle schedule) when started from that checkout's root.
--schedules (a checkout with the tree kernel) also times each tree under the
kernel's other stage schedules: every stage stopping at 2^5 nodes a CTA
(`keep`), and every stage carrying its CTAs' nodes up to one (`carry`).
Prints the card and one JSON line.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from stwo_brainfuck_tpu_torch.core import merkle  # noqa: E402
from stwo_brainfuck_tpu_torch.ops import blake2s_kernels  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("blake2s_trees: no CUDA device", file=sys.stderr)
        return 1
    schedules = {"shipped": None}
    if argv == ["--schedules"]:
        real = blake2s_kernels.tree_stages
        schedules["keep"] = lambda k, wave: real(k, 0)
        schedules["carry"] = lambda k, wave: real(k, 1 << 30)
    elif argv:
        print(f"usage: {sys.argv[0]} [--schedules]", file=sys.stderr)
        return 2
    with open(os.path.join(os.getcwd(), "programs", "fib19_io.bf")) as f:
        sigs = chip_smoke._recorded_signatures(f.read(), chip_smoke.FIB_INPUT)
    sigs = [((20, 4),)] + sigs
    rng = np.random.default_rng(7)
    out = {}
    for name, stages in schedules.items():
        if stages is not None:
            blake2s_kernels.tree_stages = stages
        for sig in sigs:
            cols = {k: chip_smoke._words(rng, (c, 1 << k)) for k, c in sig}
            top = sig[0][0]
            want = merkle.commit(cols)
            if merkle.hash_levels(None, cols, top)[0].cpu().tolist() != want.layers[0].cpu().tolist():
                raise AssertionError(f"{sig}: hash_levels and commit disagree")
            key = f"{name} {[list(t) for t in sig]}"
            out[key] = {
                "kernel_ms": chip_smoke._time_ms(lambda: merkle.hash_levels(None, cols, top)[0],
                                                 10, queued=True),
                "call_ms": chip_smoke._time_ms(lambda: merkle.commit(cols).root, 10)}
            del cols, want
        torch.cuda.empty_cache()
    print(chip_smoke._smi("name,power.limit"))
    print(json.dumps({"cwd": os.getcwd(), "trees": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
