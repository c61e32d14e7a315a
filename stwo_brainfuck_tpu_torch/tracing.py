"""Spans and counters of the prover's host work, one request at a time.

``record(request_id)`` makes a ``Recording`` active for the ``with`` block
and yields it. While one is active, ``span(name)`` records a named interval
of ``time.perf_counter_ns()`` nested in the span open around it,
``count(name, n)`` adds to a counter, and ``pull(site, tensor)`` /
``sync(site)`` wrap a read that blocks on the device: the span
``sync.<site>`` around the blocking call that is there anyway, and 1 more
in the counter ``sync.<site>``. They never synchronize themselves. The
interpreter's garbage-collection pauses are recorded as ``gc`` spans.
Where a ``torch.profiler`` runs, every span is also a profiler range named
``bf.<name>``, on the clock of the profiler's kernel and copy events (the
profiler's fast host range, ~1 us: not a user annotation, so the profiler
makes no device-side copy of it).

With no recording active (tracing off) ``span`` returns one shared no-op
context and ``count`` returns at once: a site costs one read of a global,
and nothing is allocated on the host or the device.

``self_times``, ``readings``, ``phase_of``, ``locate``, ``idle_by_span``
and ``idle_by_phase`` read recordings and profiles: each span's time less
its children's, a request's per-layer readings, the phase each span lies
in, the span open at an instant, and the device's idle gaps put down to
the innermost span open through each instant of them.
"""

from __future__ import annotations

import bisect
import gc
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

PROFILER_PREFIX = "bf."
OUTSIDE = "(outside)"  # idle time while no span is open

_ACTIVE: Optional["Recording"] = None
_NOOP = nullcontext()


@dataclass
class Span:
    request: int
    name: str
    parent: Optional[int]  # index in Recording.spans of the span it is nested in
    start_ns: int
    end_ns: int = -1


@dataclass
class Recording:
    """The spans and counters of one request."""

    request: int
    spans: List[Span] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    _open: List[int] = field(default_factory=list)      # open spans, innermost last
    _ranges: List[object] = field(default_factory=list)  # their profiler ranges
    _thread: int = field(default_factory=threading.get_ident)
    _busy: int = 0  # > 0 while _enter or _exit changes the lists above

    def _enter(self, name: str, t: Optional[int] = None) -> None:
        self._busy += 1
        try:
            parent = self._open[-1] if self._open else None
            self.spans.append(Span(self.request, name, parent,
                                   time.perf_counter_ns() if t is None else t))
            self._open.append(len(self.spans) - 1)
            rng = None
            if _profiler_enabled():
                rng = _RecordFunctionFast(PROFILER_PREFIX + name)
                rng.__enter__()
            self._ranges.append(rng)
        finally:
            self._busy -= 1

    def _exit(self) -> int:
        self._busy += 1
        try:
            rng = self._ranges.pop()
            if rng is not None:
                rng.__exit__(None, None, None)
            t = time.perf_counter_ns()
            self.spans[self._open.pop()].end_ns = t
            return t
        finally:
            self._busy -= 1

    def _next(self, name: str) -> None:
        """Close the open span and open `name` at the same instant."""
        self._busy += 1
        try:
            self._enter(name, self._exit())
        finally:
            self._busy -= 1

    def _on_gc(self, phase: str, info: dict) -> None:
        # The interpreter collects between any two calls, so also inside
        # _enter and _exit, where a `gc` span would nest in a span half
        # entered or half closed. Such a pause is left in the spans' own
        # time.
        if self._busy or threading.get_ident() != self._thread:
            return
        if phase == "start":
            self._enter("gc")
        elif self._open and self.spans[self._open[-1]].name == "gc":
            self._exit()


class _Open:
    """An active recording's span, as a context manager."""

    __slots__ = ("rec", "name")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rec._enter(self.name)
        return self

    def __exit__(self, *exc):
        self.rec._exit()
        return False


def active() -> Optional[Recording]:
    """The recording being made, or None."""
    return _ACTIVE


@contextmanager
def record(request_id: int) -> Iterator[Recording]:
    """Make a recording of request `request_id` active inside the block."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError(f"request {request_id}: request {_ACTIVE.request} is being recorded")
    rec = Recording(int(request_id))
    _ACTIVE = rec
    gc.callbacks.append(rec._on_gc)
    try:
        yield rec
    finally:
        gc.callbacks.remove(rec._on_gc)
        while rec._open:  # left open by an exception
            rec._exit()
        _ACTIVE = None


def span(name: str):
    """A context manager that records `name` as a span of the active
    recording; the shared no-op context without one."""
    rec = _ACTIVE
    if rec is None:
        return _NOOP
    return _Open(rec, name)


def count(name: str, n: int = 1) -> None:
    rec = _ACTIVE
    if rec is None:
        return
    rec.counters[name] = rec.counters.get(name, 0) + n


def sync(site: str):
    """Around a call that blocks on the device: the span `sync.<site>`,
    counted once in the counter of that name."""
    rec = _ACTIVE
    if rec is None:
        return _NOOP
    count("sync." + site)
    return _Open(rec, "sync." + site)


def pull(site: str, tensor):
    """`tensor` on the host (`tensor.cpu()`: on a card one device->host
    copy, which waits for the device), under `sync(site)`."""
    with sync(site):
        return tensor.cpu()


class _Phases:
    """Consecutive spans, one a name, each from the mark before it to its
    own: the first opens when the block starts, `mark(name)` closes the
    open one (which must be `name`) and opens the next at the same
    instant."""

    def __init__(self, rec: Recording, names: Sequence[str]):
        self.rec, self.names, self.k = rec, names, 0

    def __enter__(self):
        self.rec._enter(self.names[0])
        self.depth = len(self.rec._open)
        return self

    def mark(self, name: str) -> None:
        if self.k >= len(self.names) or name != self.names[self.k]:
            raise ValueError(f"phase {name!r} marked where {self.names[self.k:self.k + 1]} is open")
        if len(self.rec._open) != self.depth:
            raise RuntimeError(f"phase {name!r} marked with a span open inside it")
        self.k += 1
        if self.k < len(self.names):
            self.rec._next(self.names[self.k])
        else:
            self.rec._exit()

    def __exit__(self, *exc):
        if self.k < len(self.names):  # an exception left a phase open
            self.rec._exit()
        return False


class _NoPhases:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def mark(self, name: str) -> None:
        pass


_NO_PHASES = _NoPhases()


def phases(names: Sequence[str]):
    """A context manager for spans names[0], names[1], ... that follow each
    other: see _Phases. Its `mark` does nothing without an active
    recording."""
    rec = _ACTIVE
    if rec is None:
        return _NO_PHASES
    return _Phases(rec, names)


# ---------------------------------------------------------------------------
# Reading recordings and profiles
# ---------------------------------------------------------------------------

def own_ns(rec: Recording) -> List[int]:
    """Each span's nanoseconds less its children's."""
    own = [s.end_ns - s.start_ns for s in rec.spans]
    for s in rec.spans:
        if s.parent is not None:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


def self_times(recordings: Iterable[Recording]) -> Dict[str, int]:
    """Nanoseconds by span name, each span's duration less its children's,
    summed over the recordings."""
    out: Dict[str, int] = {}
    for rec in recordings:
        for s, ns in zip(rec.spans, own_ns(rec)):
            out[s.name] = out.get(s.name, 0) + ns
    return out


def sync_counts(recordings: Iterable[Recording]) -> Dict[str, int]:
    """The `sync.*` counters, summed over the recordings."""
    out: Dict[str, int] = {}
    for rec in recordings:
        for k, v in rec.counters.items():
            if k.startswith("sync."):
                out[k] = out.get(k, 0) + v
    return out


# The per-layer readings of a traced request, each a sum of self times by
# span name, in ms (with host.syncs and host.sync_wait_ms: see readings).
HOST_MS = {"decommit.host_ms": ("decommit.plan", "decommit.layout", "decommit.build"),
           "quotients.host_ms": ("quotients.claims", "quotients.constants")}


def readings(recordings: Sequence[Recording]) -> Dict[str, float]:
    """A recorded request's mean `host.syncs` (the `sync.*` counters' sum),
    `host.sync_wait_ms` (the `sync.*` spans' self time: the host blocked on
    the device) and each of HOST_MS."""
    per = len(recordings)
    own = self_times(recordings)
    out = {"host.syncs": sum(sync_counts(recordings).values()) / per,
           "host.sync_wait_ms": sum(v for k, v in own.items() if k.startswith("sync.")) / 1e6 / per}
    for name, parts in HOST_MS.items():
        out[name] = sum(own.get(p, 0) for p in parts) / 1e6 / per
    return out


def phase_of(spans: Sequence[Tuple[float, float, str]]) -> List[str]:
    """For nested (start, end, name) intervals (a recording's spans or the
    `bf.` ranges of a profile), the name of the outermost interval each lies
    in: its phase, for the spans of a prove."""
    order = sorted(range(len(spans)), key=lambda k: (spans[k][0], -spans[k][1]))
    out: List[str] = [""] * len(spans)
    stack: List[Tuple[float, str]] = []  # (end, phase) of the open intervals
    for k in order:
        a, b, name = spans[k]
        while stack and stack[-1][0] <= a:
            stack.pop()
        out[k] = stack[0][1] if stack else name
        stack.append((b, out[k]))
    return out


def innermost(spans: Sequence[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """The timeline of nested (start, end, name) intervals as consecutive
    pieces (start, end, name of the innermost interval open through it),
    OUTSIDE where none is."""
    events = sorted([(a, 1, -b, k) for k, (a, b, _) in enumerate(spans)]
                    + [(b, 0, -a, k) for k, (a, b, _) in enumerate(spans)])
    out: List[Tuple[float, float, str]] = []
    stack: List[int] = []
    t = None
    for at, opens, _, k in events:
        if t is not None and at > t:
            out.append((t, at, spans[stack[-1]][2] if stack else OUTSIDE))
        t = at
        if opens:
            stack.append(k)
        else:
            stack.remove(k)
    return out


def locate(spans: Sequence[Tuple[float, float, str]]) -> Callable[[float], str]:
    """A function of an instant: the name of the innermost of the nested
    (start, end, name) intervals open at it, OUTSIDE where none is."""
    pieces = innermost(spans)
    starts = [p[0] for p in pieces]

    def at(t: float) -> str:
        j = bisect.bisect_right(starts, t) - 1
        return pieces[j][2] if j >= 0 and pieces[j][1] >= t else OUTSIDE
    return at


def idle_by_span(gaps: Sequence[Tuple[float, float]],
                 spans: Sequence[Tuple[float, float, str]]) -> Dict[str, float]:
    """Each idle gap (start, end) split over the innermost span open at each
    instant of it (spans as (start, end, name) on the gaps' clock; OUTSIDE
    where no span is open): the idle time by span name, in the gaps'
    unit."""
    pieces = innermost(spans)
    out: Dict[str, float] = {}
    j = 0
    for a, b in sorted(gaps):
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered = a
        i = j
        while i < len(pieces) and pieces[i][0] < b:
            lo, hi = max(pieces[i][0], a), min(pieces[i][1], b)
            if lo > covered:
                out[OUTSIDE] = out.get(OUTSIDE, 0.0) + lo - covered
            if hi > lo:
                out[pieces[i][2]] = out.get(pieces[i][2], 0.0) + hi - lo
            covered = max(covered, hi)
            i += 1
        if b > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + b - covered
    return out


def idle_by_phase(gaps: Sequence[Tuple[float, float]],
                  spans: Sequence[Tuple[float, float, str]]) -> Dict[str, Tuple[float, float]]:
    """idle_by_span by phase (phase_of): for each phase, its idle time and
    the part of it in the phase's own time, in no span inside it."""
    phase = phase_of(spans)
    keyed = [(a, b, f"{ph}|{name}") for (a, b, name), ph in zip(spans, phase)]
    out: Dict[str, Tuple[float, float]] = {}
    for key, t in idle_by_span(gaps, keyed).items():
        if key == OUTSIDE:
            continue
        ph, _, name = key.partition("|")
        idle, own = out.get(ph, (0.0, 0.0))
        out[ph] = (idle + t, own + t * (name == ph))
    return out
