"""A cell on several cards: one prover process per card, SPMD over the
port's own multi-process path (``stwo_brainfuck_tpu_torch/parallel/
multihost.py``), the way ``cli prove --distributed`` proves on a host's
cards.

The process that run.py started is rank 0. It starts the other W - 1 ranks
with the same interpreter and harness (``run.py ... --rank r``), each given
STWO_BF_NUM_PROCESSES, STWO_BF_COORDINATOR (127.0.0.1 and a free port),
STWO_BF_PROCESS_ID and LOCAL_RANK. Every rank joins the process group
(NCCL on cards, gloo on the CPU), derives request i from (seed, i) itself
and proves it on ``multihost.global_mesh()``. Rank 0 alone decides after
each request whether the window goes on, and tells the others with one
broadcast on a gloo group of its own, outside the request's time. After the
window rank 0 gathers each card's readings (`card_readings`) and combines
them (`combine`); it alone records requests, judges and prints.

A failure ends the run; it never hangs it. Rank 0 watches its workers and
itself: a worker that exits non-zero, a prove that raises on any rank, or
a step that every rank takes together (a prove, the window's broadcast,
the gather) still open after STALL_S seconds (COLD_S for the set-up's
first prove of each traffic entry, which builds the kernels) kills every
worker and ends rank 0 with exit code 1, naming the rank and the cause. A
worker reads its standard input, a pipe from rank 0, and ends itself when
that pipe closes: no worker outlives rank 0, whatever ended it.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from contextlib import contextmanager
from datetime import timedelta
from pathlib import Path
from typing import Dict, List, Optional, Sequence

BENCH_DIR = Path(__file__).resolve().parent
STALL_S = 60.0
COLD_S = 300.0
POLL_S = 0.5
# variables that select a process group; a worker gets only the ones its rank is given
DIST_ENV = ("STWO_BF_NUM_PROCESSES", "STWO_BF_COORDINATOR", "STWO_BF_PROCESS_ID",
            "STWO_BF_BACKEND", "LOCAL_RANK", "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def core_sets(allowed: Sequence[int], world: int) -> List[List[int]]:
    """Each rank's cores: four of its own where the allowed set has 4 W
    (rank 0 the last four, as run.py pins a one-card run), else every rank
    the last four."""
    allowed = sorted(allowed)
    n = len(allowed)
    if n >= 4 * world:
        return [allowed[n - 4 * (r + 1): n - 4 * r] for r in range(world)]
    return [allowed[-4:]] * world


# ---------------------------------------------------------------------------
# Combining the cards' readings on rank 0
# ---------------------------------------------------------------------------

def card_readings(run) -> dict:
    """What rank 0 needs of this rank's card after the window."""
    td = run.traced
    return {"peak": int(run.peak_bytes),
            "phase_peaks": dict(td.phase_peaks) if td else {},
            "busy_s": td.busy_s if td else 0.0, "window_s": td.window_s if td else 0.0}


def fullest(peaks: Sequence[Dict[str, int]]) -> Dict[str, int]:
    """Key by key, the largest reading over the cards."""
    out: Dict[str, int] = {}
    for p in peaks:
        for k, v in p.items():
            out[k] = max(out.get(k, 0), v)
    return out


def mean_busy_s(cards: Sequence[dict], window_s: float) -> float:
    """The busy time whose share of `window_s` (rank 0's traced window) is
    the mean of the cards' busy shares, each of its own traced window: so
    1 - busy / window is the mean of the cards' idle shares."""
    return window_s * sum(c["busy_s"] / c["window_s"] for c in cards) / len(cards)


def combine(run, cards: Sequence[dict]) -> None:
    """Rank 0's run (cards[0] is its own card) takes every card's readings:
    the fullest card's allocator peak, each phase's peak on the card
    fullest in that phase, and the mean idle share; kernel times, phase
    times and idle gaps stay rank 0's."""
    run.peak_by_card = [c["peak"] for c in cards]
    run.peak_bytes = max(run.peak_by_card)
    td = run.traced
    if td is not None:
        td.phase_peaks = fullest([c["phase_peaks"] for c in cards])
        if all(c["window_s"] > 0 for c in cards):
            td.busy_s = mean_busy_s(cards, td.window_s)


# ---------------------------------------------------------------------------
# The group
# ---------------------------------------------------------------------------

class Group:
    """This process's rank of a cell's process group: its mesh, the gloo
    group that carries the window's flag and the readings, and on rank 0
    the workers and the watchdog."""

    def __init__(self, rank: int, world: int, entries: int):
        self.rank = rank
        self.world = world
        self.mesh = None
        self.ctl = None
        self.workers: List[subprocess.Popen] = []
        self._cold = entries      # the set-up's first proves, which build the kernels
        self._open_since: Optional[float] = None
        self._limit = COLD_S
        self._lock = threading.Lock()
        self._ended = False
        self._stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None

    # -- start-up ---------------------------------------------------------

    @classmethod
    def start(cls, argv: List[str], world: int, entries: int, device: str,
              cores: Optional[Sequence[int]] = None) -> "Group":
        """Rank 0: start ranks 1 .. world - 1 (`run.py <argv> --rank r`) and
        join the group with them."""
        g = cls(0, world, entries)
        port = free_port()
        sets = core_sets(cores, world) if cores else None
        if sets:
            own = len({tuple(s) for s in sets}) == world
            print(f"ranks pinned to {'four cores each' if own else 'the same four cores'}: "
                  f"{sets}", file=sys.stderr, flush=True)
        for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
            os.environ.setdefault(var, "lo")
        base = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
        try:
            for r in range(1, world):
                env = dict(base, STWO_BF_NUM_PROCESSES=str(world),
                           STWO_BF_COORDINATOR=f"127.0.0.1:{port}", STWO_BF_PROCESS_ID=str(r),
                           LOCAL_RANK=str(r))
                cmd = [sys.executable, str(BENCH_DIR / "run.py"), *argv, "--rank", str(r),
                       "--device", device]
                if sets:
                    cmd += ["--cores", ",".join(map(str, sets[r]))]
                # stdin: the pipe whose end tells the worker that rank 0 has ended;
                # stdout: this process's standard error, the only stream a worker writes
                g.workers.append(subprocess.Popen(cmd, env=env, stdin=subprocess.PIPE, stdout=2))
                print(f"rank {r}: pid {g.workers[-1].pid}", file=sys.stderr, flush=True)
            g._watchdog = threading.Thread(target=g._watch, name="bench-watchdog", daemon=True)
            g._watchdog.start()
            with g._step(COLD_S):
                g._join(device, f"127.0.0.1:{port}")
        except BaseException:
            g.abort()
            raise
        return g

    @classmethod
    def join(cls, world: int, entries: int, device: str) -> "Group":
        """Ranks 1 .. W - 1: end this process when rank 0's pipe closes, and
        join the group from the STWO_BF_* variables."""
        threading.Thread(target=_end_with_parent, name="bench-parent", daemon=True).start()
        g = cls(int(os.environ["STWO_BF_PROCESS_ID"]), world, entries)
        g._join(device, None)
        return g

    def _join(self, device: str, coordinator: Optional[str]) -> None:
        import torch.distributed as tdist
        from stwo_brainfuck_tpu_torch.parallel import multihost

        if coordinator is None:
            multihost.initialize(device=device)
        else:
            multihost.initialize(coordinator, self.world, 0, device=device)
        self.mesh = multihost.global_mesh()
        self.ctl = tdist.new_group(backend="gloo", timeout=timedelta(seconds=STALL_S))

    # -- the steps every rank takes together --------------------------------

    def proving(self, prove):
        """`prove` (harness.prove_request's signature, with `mesh=`) on this
        rank's mesh. A prove that raises ends the run."""
        def on_mesh(cell, source, inp, device, timer=None):
            limit = COLD_S if self._cold > 0 else STALL_S
            self._cold -= 1
            with self._step(limit):
                try:
                    return prove(cell, source, inp, device, timer, mesh=self.mesh)
                except Exception:
                    self.fail(f"rank {self.rank}: a prove raised:\n{traceback.format_exc()}"
                              + "".join(f"\nrank {r} exited with code {p.poll()}"
                                        for r, p in enumerate(self.workers, 1)
                                        if p.poll() is not None))
        return on_mesh

    def go_on(self, more: bool) -> bool:
        """Rank 0's `more`, on every rank: one broadcast between requests."""
        import torch
        import torch.distributed as tdist

        flag = torch.tensor([int(more)], dtype=torch.int32)
        with self._step(STALL_S):
            tdist.broadcast(flag, src=0, group=self.ctl)
        return bool(flag.item())

    def finish(self, run) -> None:
        """After the window: rank 0 gathers every card's readings into
        `run`, leaves the group and waits for each worker to end, which has
        to end with code 0; a worker sends its readings and leaves."""
        import torch.distributed as tdist
        from stwo_brainfuck_tpu_torch.parallel import multihost

        cards = [None] * self.world if self.rank == 0 else None
        with self._step(STALL_S):
            tdist.gather_object(card_readings(run), cards, dst=0, group=self.ctl)
        multihost.shutdown()
        if self.rank != 0:
            return
        combine(run, cards)
        self._stop.set()
        self._watchdog.join()
        deadline = time.monotonic() + STALL_S
        for r, p in enumerate(self.workers, 1):
            try:
                code = p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                code = None
            if code != 0:
                self.abort()
                raise RuntimeError(f"rank {r} ended with code {code} after the window")
            p.stdin.close()

    @contextmanager
    def _step(self, limit: float):
        self._limit = limit
        self._open_since = time.monotonic()
        try:
            yield
        finally:
            self._open_since = None

    # -- ending ---------------------------------------------------------------

    def _claim_end(self) -> bool:
        with self._lock:
            first = not self._ended
            self._ended = True
            return first

    def _watch(self) -> None:
        while not self._stop.wait(POLL_S):
            for r, p in enumerate(self.workers, 1):
                code = p.poll()
                if code not in (None, 0):
                    self.fail(f"rank {r} exited with code {code}")
            since = self._open_since
            if since is not None and time.monotonic() - since > self._limit:
                self.fail(f"rank 0 has waited {time.monotonic() - since:.0f} s in a step that "
                          "every rank takes together: a rank does not take it")

    def fail(self, why: str) -> None:
        """End the run now: print why, end every worker, exit with code 1."""
        if self._claim_end():
            print(f"the run ends: {why}", file=sys.stderr, flush=True)
            self._kill()
            os._exit(1)
        # another thread is ending the run; this one waits for the exit
        threading.Event().wait()

    def abort(self) -> None:
        """End every worker (rank 0, on its way out with an exception)."""
        if self._claim_end():
            self._stop.set()
            self._kill()

    def _kill(self) -> None:
        for p in self.workers:
            if p.poll() is None:
                p.kill()
            p.wait()
            if p.stdin:
                p.stdin.close()


def _end_with_parent() -> None:
    """A worker's watch on rank 0: its standard input reaches its end when
    rank 0 has ended."""
    try:
        while os.read(0, 4096):  # unbuffered: a daemon thread may hold no lock at exit
            pass
    finally:
        print("rank 0 has ended: this rank ends", file=sys.stderr, flush=True)
        os._exit(1)
