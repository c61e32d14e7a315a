"""Entry points of the port, beside the JAX package's ``__graft_entry__.py``.

    entry()                         -> (fn, example_args): the Memory
                                       component's LogUp interaction build
                                       (fractions + prefix sum) on the small
                                       program's tables
    dryrun_multichip(n, device)     -> proves the small program on a mesh of
                                       n shards, verifies it, and checks that
                                       its JSON equals the one-device proof's

    python -m stwo_brainfuck_tpu_torch.entry [N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

SMALL_CODE = "+++>,<[>+.<-]"
SMALL_INPUT = b"\x01"


def _small_machine():
    from .vm.compiler import compile_program
    from .vm.machine import create_test_machine

    m = create_test_machine(compile_program(SMALL_CODE), SMALL_INPUT)
    m.execute()
    return m


def entry(device="cuda"):
    """(fn, args): fn(*args) is build_interaction_trace of the Memory
    component on the small program's table, with dummy lookup elements;
    it returns ([Q, S] (4, N) columns, the claimed sum)."""
    from .components import device_build
    from .components.defs import ELEMENT_SIZES, MemoryComponent
    from .framework.component import LookupElements, build_interaction_trace

    m = _small_machine()
    meta = device_build.build_meta(m.trace(), m.program())
    mats = device_build.build_device_tables(m.trace(), meta, torch.device(device))
    comp = MemoryComponent(meta.claim[MemoryComponent.name])
    main = {c: mats[comp.name][i] for i, c in enumerate(comp.columns)}
    els = {k: LookupElements.dummy(s) for k, s in ELEMENT_SIZES.items()}
    return build_interaction_trace, (comp, main, els)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The whole prove of the small program on a mesh of `n_devices` shards
    (parallel/mesh.make_mesh over `device`'s type), verified, and
    byte-identical to the one-device proof."""
    from . import air
    from .parallel.mesh import make_mesh

    mesh = make_mesh(n_devices, device)
    proof_mesh = air.prove_brainfuck(_small_machine(), device=device, mesh=mesh)
    air.verify_brainfuck(proof_mesh, device=device)
    proof_single = air.prove_brainfuck(_small_machine(), device=device)
    if json.dumps(proof_mesh, sort_keys=True) != json.dumps(proof_single, sort_keys=True):
        raise AssertionError("the mesh proof differs from the one-device proof")
    print(f"dryrun_multichip({n_devices}): mesh prove verified, "
          f"byte-identical to the one-device proof")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("n_devices", type=int, nargs="?", default=8)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    fn, fargs = entry(args.device)
    cols, claimed = fn(*fargs)
    print("entry() ran:", [tuple(c.shape) for c in cols], claimed)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
