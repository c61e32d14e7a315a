"""Multi-process proving over ``torch.distributed``.

Counterpart of ``stwo_brainfuck_tpu/parallel/multihost.py``. Every process
runs the same program (SPMD): it runs the VM, builds the tables on its own
device and proves on ``global_mesh()``, a ``ProcessGroupMesh`` with one
shard per process, through the same prover as the one-process mesh
(``air.prove_brainfuck(machine, mesh=...)``). Every value mixed into the
Blake2s channel comes out of a collective, so every process holds the same
channel and the proof is byte-identical to the one-device proof for any
world size; process 0 writes it (``is_coordinator``).

Launch (one process per card of a host, NCCL)::

    torchrun --nproc-per-node 4 -m stwo_brainfuck_tpu_torch.cli prove ... --distributed

or set ``STWO_BF_NUM_PROCESSES``, ``STWO_BF_COORDINATOR`` (``host:port`` of
process 0) and ``STWO_BF_PROCESS_ID`` in each process, as for the JAX
package. ``STWO_BF_BACKEND`` names the backend: ``nccl`` by default on
CUDA devices, ``gloo`` on the CPU; processes that share one card ask for
``gloo``, since NCCL refuses two ranks on one device.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as tdist

from ..air import canonical_device
from .mesh import DeviceMesh, Mesh, ProcessGroupMesh

# a collective that one process never reaches ends in an error after this,
# not in a hang
TIMEOUT = timedelta(seconds=600)

_home: Optional[torch.device] = None


def rank_device(device, local_rank: int) -> torch.device:
    """This process's device: an indexed device as given, "cuda" the card
    cuda:{local_rank % visible cards}, "cpu" the CPU. Raises if a card is
    asked for and there is none."""
    dev = canonical_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device="cuda") -> None:
    """Join the process group. Arguments left as None are read from
    STWO_BF_NUM_PROCESSES / STWO_BF_COORDINATOR / STWO_BF_PROCESS_ID /
    STWO_BF_BACKEND, failing those from torchrun's WORLD_SIZE / RANK /
    MASTER_ADDR / MASTER_PORT. One process with no coordinator is a no-op
    beyond choosing the device. A backend that fails to initialise raises."""
    global _home
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("STWO_BF_NUM_PROCESSES", env.get("WORLD_SIZE", "1")))
    if coordinator_address is None:
        coordinator_address = env.get("STWO_BF_COORDINATOR")
        if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if process_id is None:
        process_id = int(env.get("STWO_BF_PROCESS_ID", env.get("RANK", "0")))
    home = rank_device(device, int(env.get("LOCAL_RANK", process_id)))
    if num_processes <= 1 and coordinator_address is None:
        _home = home
        return
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes need a coordinator address")
    backend = backend or env.get("STWO_BF_BACKEND") or ("nccl" if home.type == "cuda" else "gloo")
    if backend == "nccl" and home.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if home.type == "cuda":
        torch.cuda.set_device(home)
    tdist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                             world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    _home = home
    # a first collective that every process takes part in: it sets up the
    # communicator now (an NCCL fault shows here) and before any
    # point-to-point call
    probe = torch.ones(1, device=home if backend == "nccl" else "cpu")
    tdist.all_reduce(probe)
    if int(probe.item()) != num_processes:
        raise RuntimeError(f"process group of {num_processes} summed {probe.item()}")


def global_mesh() -> Mesh:
    """The mesh of all processes, one shard each (D = world size, a power
    of two); without a process group, one shard on this process's device."""
    if _home is None:
        raise RuntimeError("multihost.initialize() has not run")
    if not tdist.is_initialized():
        return DeviceMesh((_home,))
    return ProcessGroupMesh(tdist.get_world_size(), tdist.get_rank(), _home,
                            tdist.get_backend())


def is_coordinator() -> bool:
    """True on the process that writes the proof file / prints output."""
    return not tdist.is_initialized() or tdist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group (if one was joined)."""
    global _home
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _home = None
