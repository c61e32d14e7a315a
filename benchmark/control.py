"""The control of a cell's correctness check: the port with a guarantee of
the configuration broken, judged by the same reference as a run.

The configuration states its security (log_blowup * n_queries + pow_bits
conjectured bits). The control proves each request with one query fewer
than the configuration states, the step that would tempt a change that
wants a shorter decommitment, and labels the proof with the stated
configuration; the reference has to reject every such proof.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

prints one JSON line a seed: the numbers compared (as a run's `checks`)
for the control's proofs, and, beside them, for the port's sound proofs of
the same requests. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import harness  # noqa: E402


def control_config(config: dict) -> dict:
    """The stated configuration with one query fewer."""
    return dict(config, n_queries=config["n_queries"] - 1)


def prove_as(config: dict, label: dict):
    """A prove_request that proves at `config` and labels the proof `label`."""
    def prove(cell, source, inp, device, timer=None):
        machine, proof, vm_s = harness.prove_request(dataclasses.replace(cell, config=config),
                                                     source, inp, device, timer)
        proof["config"] = dict(label)
        return machine, proof, vm_s
    return prove


def judge_seed(cell: harness.Cell, seed: int, device: str, prove) -> dict:
    """Prove the cell's first `checked_requests` requests of `seed` with
    `prove` and judge them as a run's sample."""
    kept = []
    for i in range(harness.sample_size(cell)):
        entry = cell.traffic.entry(seed, i)
        source, inp = cell.traffic.request(seed, i, entry)
        machine, proof, _ = prove(cell, source, inp, device)
        kept.append(harness.Kept(i, source, inp, machine.output_bytes(),
                                 int(len(machine.trace())), proof, cell.claims[entry.name]))
        del machine, proof
    harness.free_program_state(device)
    from reference.check import judge_requests

    return judge_requests(kept, cell.config, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        control = judge_seed(cell, seed, args.device,
                             prove_as(control_config(cell.config), cell.config))
        sound = judge_seed(cell, seed, args.device, harness.prove_request)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": control,
                          "sound": sound, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
