"""brainfuck_prover CLI for the torch port: prove / verify subcommands.

Counterpart of ``stwo_brainfuck_tpu/cli.py``:

    python -m stwo_brainfuck_tpu_torch.cli prove --file prog.bf --output proof.json
    python -m stwo_brainfuck_tpu_torch.cli verify proof.json

``--device`` defaults to ``cuda`` for both; on a machine without a GPU that
raises rather than carrying on on the CPU (pass ``--device cpu`` there).
``prove --devices N`` proves on a mesh of N shards over the visible devices
of ``--device``'s type (``parallel/mesh.make_mesh``; on one card all N
shards share it). ``prove --distributed`` joins a ``torch.distributed``
process group and proves with one shard per process
(``parallel/multihost.py``); every process runs the same command and
process 0 alone writes ``--output`` / ``--print``. Launch it with torchrun,
one process per card (NCCL):

    torchrun --nproc-per-node 4 -m stwo_brainfuck_tpu_torch.cli prove --file prog.bf \
        --output proof.json --distributed

or start each process with STWO_BF_NUM_PROCESSES, STWO_BF_COORDINATOR
(``host:port`` of process 0) and STWO_BF_PROCESS_ID set; STWO_BF_BACKEND=gloo
for processes that share one card or run on the CPU. The proof is the same
bytes for any N and any number of processes. The log level is ``--log``,
else the STWO_BF_LOG environment variable, else info (under torchrun set
STWO_BF_LOG: torchrun's own parser takes ``--log`` for its ``--log-dir``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import torch

from . import air
from .core import blake2s, fft, fri, poly, quotients
from .core.pcs import PcsConfig
from .framework import component as framework
from .components import device_build
from .ops import (blake2s_kernels, circle_fft, constraint_kernels, fri_kernels, oods_kernels,
                  quotient_kernels, table_kernels)
from .vm.compiler import CompileError, compile_program
from .vm.machine import DEFAULT_RAM_SIZE, Machine, MachineError
from .vm.registers import TRACE_COLUMNS

log = logging.getLogger("stwo_brainfuck_tpu_torch")


def _add_prove_args(p):
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--file", help="path to a .bf program")
    src.add_argument("--code", help="Brainfuck source as a string")
    p.add_argument("--trace", action="store_true", help="print the execution trace")
    p.add_argument("--memory", action="store_true", help="print the RAM contents")
    p.add_argument("--ram-size", type=int, default=DEFAULT_RAM_SIZE)
    p.add_argument("--input", default=None, help="program input string (else stdin)")
    out = p.add_mutually_exclusive_group()
    out.add_argument("--output", help="write the proof JSON to this path")
    out.add_argument("--print", action="store_true", help="print the proof JSON")
    p.add_argument("--log", default=None, help="log level (default: $STWO_BF_LOG, else info)")
    p.add_argument("--log-max-rows", type=int, default=0,
                   help="preprocessed ladder top (0 = auto from trace)")
    p.add_argument("--n-queries", type=int, default=20)
    p.add_argument("--pow-bits", type=int, default=10)
    p.add_argument("--device", default="cuda", help="torch device to prove on")
    mesh = p.add_mutually_exclusive_group()
    mesh.add_argument("--devices", type=int, default=0,
                      help="prove on a mesh of N shards (a power of two) over the visible "
                           "devices of --device's type; 0 = one device")
    mesh.add_argument("--distributed", action="store_true",
                      help="join the torch.distributed process group and prove with one "
                           "shard per process (each on its own --device card); every "
                           "process runs this same command")


def cmd_prove(args) -> int:
    device = air.canonical_device(args.device)
    if args.file:
        with open(args.file) as f:
            source = f.read()
    else:
        source = args.code
    code = compile_program(source)

    input_data = args.input.encode() if args.input is not None else sys.stdin.buffer
    machine = Machine(code, input_data=input_data, output=sys.stdout.buffer,
                      ram_size=args.ram_size)

    t0 = time.time()
    machine.execute()
    sys.stdout.buffer.flush()
    trace_time = time.time() - t0
    steps = len(machine.trace())
    log.info("Steps: %d (%s VM)", steps, machine.vm)
    log.info("Trace generation speed: %.2f MHz", steps / max(trace_time, 1e-9) / 1e6)

    if args.trace:
        tr = machine.trace()
        print("\n" + " ".join(f"{c:>10}" for c in TRACE_COLUMNS), file=sys.stderr)
        for row in tr:
            print(" ".join(f"{v:>10}" for v in row), file=sys.stderr)
    if args.memory:
        ram = machine.memory()
        last = max((i for i, v in enumerate(ram) if v), default=0)
        print(f"[Memory] {ram[: last + 1]}", file=sys.stderr)

    config = PcsConfig(log_max_rows=args.log_max_rows, n_queries=args.n_queries,
                       pow_bits=args.pow_bits)
    log.debug("PCS config: %s", config.to_json())
    mesh = None
    coordinator = True
    if args.distributed:
        from .parallel import multihost

        multihost.initialize(device=args.device)
        mesh = multihost.global_mesh()
        coordinator = multihost.is_coordinator()
        log.info("Process %d of %d on %s", mesh.local[0], mesh.size, mesh.home)
    elif args.devices:
        from .parallel.mesh import make_mesh

        mesh = make_mesh(args.devices, args.device)
        log.info("Mesh: %d shards on %s", mesh.size,
                 ", ".join(sorted({str(d) for d in mesh.devices})))
    try:
        t0 = time.time()
        proof = air.prove_brainfuck(machine, config, device=device, mesh=mesh)
        for dev in {device} if mesh is None else mesh.local_devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        proof_time = time.time() - t0
    finally:
        if args.distributed:
            multihost.shutdown()
    log.info("Proof generation speed: %.2f kHz", steps / max(proof_time, 1e-9) / 1e3)
    log.info("Execution trace time: %.1f ms; proof time: %.2f s; total: %.2f s",
             trace_time * 1e3, proof_time, trace_time + proof_time)
    log.info("Circle FFT kernel launches: %d; plain FFT calls on CUDA tensors: %d",
             circle_fft.KERNEL.launches, fft.PLAIN_CUDA_CALLS)
    hashes = blake2s_kernels.KERNELS.launches
    log.info("Blake2s kernel launches: tree %d, level %d, grind %d; plain Blake2s calls on "
             "CUDA tensors: %d", hashes["tree"], hashes["level"], hashes["grind"],
             blake2s.PLAIN_CUDA_CALLS)
    log.info("Quotient kernel launches: %d; plain quotient calls on CUDA tensors: %d",
             quotient_kernels.KERNEL.launches, quotients.PLAIN_CUDA_CALLS)
    cons = constraint_kernels.KERNELS.launches
    log.info("constraint kernel launches: composition %d, interaction %d, logup %d, scan %d; "
             "plain constraint calls on CUDA tensors: %d", cons["composition"],
             cons["interaction"], cons["logup"], cons["scan"], framework.PLAIN_CUDA_CALLS)
    log.info("OODS kernel launches: %d, fold kernel launches: %d; plain OODS and fold calls on "
             "CUDA tensors: %d", oods_kernels.KERNEL.launches, fri_kernels.KERNEL.launches,
             poly.PLAIN_CUDA_CALLS + fri.PLAIN_CUDA_CALLS)
    log.info("Table kernel launches: %d; host table passes and plain table builds on CUDA: %d",
             table_kernels.KERNEL.launches,
             device_build.META_CALLS + table_kernels.PLAIN_CUDA_CALLS)
    if not coordinator:
        return 0  # the proof is the same in every process; process 0 writes it

    payload = json.dumps(proof)
    if args.output:
        with open(args.output, "w") as f:
            f.write(payload)
        log.info("Proof written to %s (%d bytes)", args.output, len(payload))
    elif args.print:
        print(payload)
    return 0


def cmd_verify(args) -> int:
    device = air.canonical_device(args.device)
    with open(args.proof) as f:
        proof = json.load(f)
    t0 = time.time()
    try:
        air.verify_brainfuck(proof, device=device)
    except air.VerificationError as exc:
        log.error("Verification FAILED: %s", exc)
        return 1
    log.info("Verification OK (%.4f s)", time.time() - t0)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="brainfuck_prover", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)
    p_prove = sub.add_parser("prove", help="prove a Brainfuck program execution")
    _add_prove_args(p_prove)
    p_verify = sub.add_parser("verify", help="verify a proof JSON")
    p_verify.add_argument("proof", help="path to the proof JSON")
    p_verify.add_argument("--log", default=None,
                          help="log level (default: $STWO_BF_LOG, else info)")
    p_verify.add_argument("--device", default="cuda",
                          help="torch device for the preprocessed-root recompute")
    args = parser.parse_args(argv)

    level = args.log or os.environ.get("STWO_BF_LOG") or "info"
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )
    try:
        if args.command == "prove":
            return cmd_prove(args)
        return cmd_verify(args)
    except FileNotFoundError as exc:
        log.error("%s: no such file", exc.filename)
        return 2
    except json.JSONDecodeError as exc:
        log.error("invalid proof JSON: %s", exc)
        return 2
    except (CompileError, MachineError, air.ProvingError) as exc:
        log.error("%s", exc)
        return 2


if __name__ == "__main__":
    sys.exit(main())
