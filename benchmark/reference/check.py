"""The judgement of a run's sampled requests.

For each request the reference runs the program on its own interpreter,
builds the 13 component tables, and compares:

- `vm_mismatch`: the port's output bytes and step count against its own;
- `claim_mismatch`: the proof's claim (each component's log size) against
  the tables' sizes and the cell's;
- `main_root_mismatch`: the proof's main-trace commitment against the root
  of its own tables, extended and hashed in plain PyTorch;
- `rejected`: the proof fails a check of reference/verify.py at the cell's
  configuration (the transcript, the LogUp sum, the composition identity
  at the OODS point, every decommitment, the quotients, FRI, the proof of
  work), the preprocessed root worked out from the ladder.

Each number counts requests; the limit of each is 0. The preprocessed root
is worked out once for each ladder the sample's claims give.
"""

from __future__ import annotations

import sys
from typing import Dict, Sequence

from . import commit, tables, verify, vm


def reference_claim(tabs) -> Dict[str, int]:
    return {name: len(next(iter(cols.values()))).bit_length() - 1 for name, cols in tabs.items()}


def judge_requests(kept: Sequence, config: dict, device) -> Dict[str, int]:
    """`kept`: the sampled requests, each with the claim the cell gives its
    traffic entry (`claim`)."""
    cfg = verify.PcsConfig(**config)
    counts = {"vm_mismatch": 0, "claim_mismatch": 0, "main_root_mismatch": 0, "rejected": 0}
    pre_roots = {}  # ladder -> preprocessed root
    for req in kept:
        claim = req.claim
        ladder = tuple(verify.ladder_of(claim, cfg))
        if ladder not in pre_roots:
            pre_roots[ladder] = commit.ladder_root(ladder, cfg.log_blowup, device)
        code = vm.compile_program(req.source)
        trace, output = vm.run(code, req.input)
        if output != req.output or len(trace) != req.steps:
            counts["vm_mismatch"] += 1
            print(f"request {req.index}: VM output or steps differ "
                  f"({req.steps} against {len(trace)})", file=sys.stderr)
        tabs = tables.all_tables(trace, code)
        ref_claim = reference_claim(tabs)
        proof_claim = {k: int(v) for k, v in req.proof["claim"].items()}
        if not (proof_claim == ref_claim == claim):
            counts["claim_mismatch"] += 1
            print(f"request {req.index}: claim {proof_claim}, tables {ref_claim}", file=sys.stderr)
        root = commit.trace_root(verify.main_columns(tabs, ref_claim), cfg.log_blowup, device)
        del tabs, trace
        if req.proof["commitments"][1] != root.hex():
            counts["main_root_mismatch"] += 1
            print(f"request {req.index}: the main-trace root differs", file=sys.stderr)
        try:
            verify.verify(req.proof, cfg, pre_roots[ladder])
        except (verify.Rejected, KeyError, ValueError, TypeError, IndexError) as exc:
            counts["rejected"] += 1
            print(f"request {req.index}: proof rejected: {type(exc).__name__}: {exc}",
                  file=sys.stderr)
    return counts
