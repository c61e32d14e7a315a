"""The port's tracer (stwo_brainfuck_tpu_torch/tracing.py) on a CPU prove.

A prove of the small program recorded under tracing.record gives the
proof it gives unrecorded, byte for byte; its top-level spans are
air.PHASES, back to back; every span lies inside its parent and carries
the request id; the `sync.*` counters follow the prove's structure, and
`quotients.powers` reads the claims' count; under
torch.profiler every span is a `bf.` range. A 2-process gloo prove records
its collectives (`mesh.<op>` spans and counters, `mesh.bytes` the payloads'
sum) and its cross stages (`fft.cross`) inside the phases. Outside a recording a span is
one shared no-op context and nothing is recorded, and a collection inside
the tracer's own bookkeeping leaves the nesting whole. The readers
(self_times, readings, phase_of, locate, idle_by_span, idle_by_phase) on
hand-made spans and gaps."""

import collections
import gc
import json
import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from stwo_brainfuck_tpu_torch import air, bench, tracing
from stwo_brainfuck_tpu_torch.entry import _small_machine

REQUEST = 7


@pytest.fixture(scope="module")
def proves():
    """The small program proved unrecorded, then recorded (and timed
    around the call), and whether the recorded prove found the
    preprocessed tree in its cache."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        plain = air.prove_brainfuck(_small_machine(), device="cpu")
        machine = _small_machine()
        hits = air._preprocessed_tree.cache_info().hits
        t0 = time.perf_counter_ns()
        with tracing.record(REQUEST) as rec:
            proof = air.prove_brainfuck(machine, device="cpu")
        t1 = time.perf_counter_ns()
        cached = air._preprocessed_tree.cache_info().hits > hits
    finally:
        torch.set_num_threads(threads)
    return {"plain": plain, "proof": proof, "rec": rec, "t": (t0, t1), "cached": cached}


def _check_nesting(rec):
    """Every span has ended, comes after its parent and lies inside it."""
    for k, s in enumerate(rec.spans):
        assert s.start_ns <= s.end_ns, s.name
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert s.parent < k, (p.name, s.name)
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p.name, s.name)


def test_a_recorded_prove_is_byte_identical(proves):
    assert json.dumps(proves["proof"]) == json.dumps(proves["plain"])
    assert bench.proof_sha256(proves["proof"]) == bench.REFERENCE_SHA256["small"]


def test_the_top_level_spans_are_the_phases_back_to_back(proves):
    rec = proves["rec"]
    # a garbage-collection pause while no phase is open is a top-level span too
    top = [s for s in rec.spans if s.parent is None and s.name != "gc"]
    assert tuple(s.name for s in top) == air.PHASES
    t0, t1 = proves["t"]
    assert t0 <= top[0].start_ns and top[-1].end_ns <= t1
    for before, after in zip(top, top[1:]):
        assert after.start_ns == before.end_ns, (before.name, after.name)


def test_every_span_lies_inside_its_parent_and_carries_the_request_id(proves):
    rec = proves["rec"]
    assert rec.request == REQUEST and rec.spans
    assert all(s.request == REQUEST for s in rec.spans)
    _check_nesting(rec)


def test_the_sync_counters_follow_the_prove(proves):
    rec, proof = proves["rec"], proves["proof"]
    trees = 3 if proves["cached"] else 4  # tree0 comes from the cache or is committed
    layers = len(proof["fri"]["layer_roots"])
    assert tracing.sync_counts([rec]) == {
        "sync.tables": 1, "sync.root": trees + layers, "sync.claimed": 1, "sync.oods": 1,
        "sync.fri_last": 1, "sync.decommit": 1}
    # each counted sync is a span of its name
    spans = collections.Counter(s.name for s in rec.spans if s.name.startswith("sync."))
    assert dict(spans) == tracing.sync_counts([rec])


def test_the_alpha_powers_are_built_once_a_prove(proves):
    """quotients.powers: one ladder a prove, as long as the claims' count
    (every sampled value is a claim), whatever the number of sizes."""
    rec, proof = proves["rec"], proves["proof"]
    claims = sum(len(cvals) for tvals in proof["sampled_values"] for cvals in tvals)
    assert rec.counters["quotients.powers"] == claims


def test_under_the_profiler_every_span_is_a_bf_range():
    machine = _small_machine()
    timer = air.PhaseTimer("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.record(3) as rec:
            air.prove_brainfuck(machine, device="cpu", timer=timer)
    ranges = collections.Counter(
        ev.name[len(tracing.PROFILER_PREFIX):] for ev in prof.events()
        if ev.device_type == DeviceType.CPU and ev.name.startswith(tracing.PROFILER_PREFIX))
    assert ranges == collections.Counter(s.name for s in rec.spans)
    assert set(air.PHASES) <= set(ranges)
    # the timer still gets every mark, each inside the phase it ends
    assert tuple(timer.seconds) == air.PHASES
    marks = [s for s in rec.spans if s.name == "timer.mark"]
    assert [rec.spans[s.parent].name for s in marks] == list(air.PHASES)


MESH_OPS = ("all_gather", "exchange", "shift", "permute", "sum", "gather_many", "full", "pad")


def test_a_two_process_prove_records_its_collectives_inside_the_phases(proves, tmp_path):
    """A 2-process gloo prove of the small program inside a recording: the
    one-device proof's bytes; a `mesh.<op>` span for each counted
    collective and `fft.cross` spans, every one inside a prove phase; and
    `mesh.bytes` the sum of the payloads the process handed to
    torch.distributed."""
    import os
    import socket
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    try:
        for rank in range(2):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("STWO_BF_") and k not in (
                       "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
            env.update(STWO_BF_NUM_PROCESSES="2", STWO_BF_COORDINATOR=f"127.0.0.1:{port}",
                       STWO_BF_PROCESS_ID=str(rank), PYTHONPATH=root, OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(root, "tests", "torch_multihost_worker.py"),
                 str(tmp_path), "traced_prove"], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}: {err.decode()[-3000:]}"
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert got["traced_proof"] == json.dumps(proves["plain"]), rank
        counters = got["traced_counters"]
        spans = collections.Counter(name for name, _ in got["traced_spans"])
        ops = {k[len("mesh."):]: v for k, v in counters.items()
               if k.startswith("mesh.") and k != "mesh.bytes"}
        assert set(ops) <= set(MESH_OPS)
        assert {"exchange", "permute", "all_gather", "sum", "gather_many", "pad"} <= set(ops)
        for op, n in ops.items():
            assert spans["mesh." + op] == n, op
        assert spans["fft.cross"] > 0
        for name, phase in got["traced_spans"]:
            if name.startswith("mesh.") or name == "fft.cross":
                assert phase in air.PHASES, (name, phase)
        assert counters["mesh.bytes"] == got["traced_payloads"] > 0


def test_outside_a_recording_nothing_is_recorded():
    assert tracing.active() is None
    assert tracing.span("a") is tracing.span("b") is tracing.sync("c")
    with tracing.record(1) as rec:
        pass
    callbacks = list(gc.callbacks)
    with tracing.span("a"):
        tracing.count("a")
        x = torch.arange(4)
        assert tracing.pull("x", x) is x  # a CPU tensor's pull is the tensor
    air.prove_brainfuck(_small_machine(), device="cpu")
    assert rec.spans == [] and rec.counters == {}
    assert tracing.active() is None and gc.callbacks == callbacks


def test_a_garbage_collection_pause_is_a_span_in_the_open_one():
    with tracing.record(0) as rec:
        with tracing.span("outer"):
            gc.collect()
    names = [s.name for s in rec.spans]
    assert names[0] == "outer" and "gc" in names
    assert all(rec.spans[s.parent].name == "outer" for s in rec.spans if s.name == "gc")


class _Collect:
    """One collection, made where the span named `at` is entered or closed."""

    def __init__(self, at: str):
        self.at, self.done = at, False

    def __call__(self, name: str) -> None:
        if name == self.at and not self.done:
            self.done = True
            gc.collect()


@pytest.mark.parametrize("where", ["building", "stored", "pushed", "popped", "switched"])
def test_a_collection_inside_the_tracer_s_bookkeeping_keeps_the_nesting(where, monkeypatch):
    """A collection while `inner` is built, just after it is stored, just
    before it is pushed as the open span, just after it is popped, or while
    phase `a` is closed and `b` opened: the nesting holds, and the pause is
    in the spans' own time, not a `gc` span."""
    collect = _Collect("b" if where == "switched" else "inner")

    class Span(tracing.Span):
        def __init__(self, *args):
            super().__init__(*args)
            collect(self.name)

    class Spans(list):
        def append(self, sp):
            super().append(sp)
            collect(sp.name)

    class Open(list):
        def append(self, k):
            collect(rec.spans[k].name)
            super().append(k)

        def pop(self):
            k = super().pop()
            if where == "popped":
                collect(rec.spans[k].name)
            return k

    if where == "building":
        monkeypatch.setattr(tracing, "Span", Span)
    with tracing.record(0) as rec:
        if where == "stored":
            rec.spans = Spans()
        if where in ("pushed", "popped", "switched"):
            rec._open = Open()
        with tracing.phases(("a", "b")) as ph:
            with tracing.span("outer"):
                with tracing.span("inner"):
                    pass
            ph.mark("a")
            ph.mark("b")
    assert collect.done
    assert [s.name for s in rec.spans] == ["a", "outer", "inner", "b"]
    _check_nesting(rec)
    assert [s.parent for s in rec.spans] == [None, 0, 1, None]
    assert rec.spans[3].start_ns == rec.spans[0].end_ns
    assert all(ns >= 0 for ns in tracing.own_ns(rec))
    assert rec._open == [] and rec._ranges == []


def test_recordings_do_not_nest():
    with tracing.record(0):
        with pytest.raises(RuntimeError):
            with tracing.record(1):
                pass
    assert tracing.active() is None


def test_self_times_take_the_children_off():
    with tracing.record(0) as rec:
        with tracing.phases(("a", "b")) as ph:
            with tracing.span("x"):
                pass
            ph.mark("a")
            with tracing.sync("s"):
                pass
            ph.mark("b")
    spans = {s.name: s for s in rec.spans}
    own = tracing.self_times([rec])
    a, x = spans["a"], spans["x"]
    assert own["a"] == (a.end_ns - a.start_ns) - (x.end_ns - x.start_ns)
    assert own["sync.s"] == spans["sync.s"].end_ns - spans["sync.s"].start_ns
    assert rec.counters == {"sync.s": 1}


def test_a_phase_marked_out_of_order_is_refused():
    with tracing.record(0):
        with tracing.phases(("a", "b")) as ph:
            with pytest.raises(ValueError):
                ph.mark("b")


def test_a_gap_is_split_over_the_spans_it_overlaps():
    spans = [(0.0, 10.0, "decommit"), (2.0, 10.0, "decommit.build"),
             (12.0, 30.0, "vm.execute"), (14.0, 16.0, "gc")]
    # begins in decommit.build, runs on through the next request's vm.execute
    assert tracing.idle_by_span([(5.0, 20.0)], spans) == {
        "decommit.build": 5.0, tracing.OUTSIDE: 2.0, "vm.execute": 6.0, "gc": 2.0}
    assert tracing.idle_by_span([(1.0, 3.0), (31.0, 33.0)], spans) == {
        "decommit": 1.0, "decommit.build": 1.0, tracing.OUTSIDE: 2.0}
    assert tracing.idle_by_span([], spans) == {}
    at = tracing.locate(spans)
    assert [at(t) for t in (-1.0, 1.0, 5.0, 11.0, 15.0, 20.0, 31.0)] == [
        tracing.OUTSIDE, "decommit", "decommit.build", tracing.OUTSIDE, "gc", "vm.execute",
        tracing.OUTSIDE]


def test_phase_of_names_the_outermost_span(proves):
    spans = [(0, 5, "a"), (1, 2, "a.x"), (2, 4, "gc"), (5, 9, "b"), (5, 6, "b.y"), (9, 9, "c")]
    assert tracing.phase_of(spans) == ["a", "a", "a", "b", "b", "c"]
    # on a recording it follows the parents
    rec = proves["rec"]
    phase = tracing.phase_of([(s.start_ns, s.end_ns, s.name) for s in rec.spans])
    for k, s in enumerate(rec.spans):
        top = s
        while top.parent is not None:
            top = rec.spans[top.parent]
        assert phase[k] == top.name, s.name


def test_readings_sum_the_sync_counters_and_self_times():
    with tracing.record(0) as a:
        with tracing.span("decommit"):
            with tracing.span("decommit.plan"):
                with tracing.sync("decommit"):
                    pass
            with tracing.span("decommit.build"):
                pass
        with tracing.span("quotients"):
            with tracing.span("quotients.claims"):
                pass
    with tracing.record(1) as b:
        with tracing.sync("root"):
            pass
        with tracing.sync("root"):
            pass
    own = tracing.self_times([a, b])
    got = tracing.readings([a, b])
    assert got["host.syncs"] == 1.5
    assert got["host.sync_wait_ms"] == pytest.approx(
        (own["sync.decommit"] + own["sync.root"]) / 1e6 / 2)
    assert got["decommit.host_ms"] == pytest.approx(
        (own["decommit.plan"] + own["decommit.build"]) / 1e6 / 2)
    assert got["quotients.host_ms"] == pytest.approx(own["quotients.claims"] / 1e6 / 2)
    assert set(got) == {"host.syncs", "host.sync_wait_ms", *tracing.HOST_MS}


def test_idle_by_phase_parts_a_phase_s_idle_from_its_own_time():
    spans = [(0.0, 10.0, "decommit"), (2.0, 6.0, "decommit.build"), (4.0, 5.0, "sync.decommit"),
             (12.0, 30.0, "vm.execute")]
    got = tracing.idle_by_phase([(1.0, 5.0), (9.0, 14.0)], spans)
    # decommit: 1-2 and 9-10 its own, 2-4 in decommit.build, 4-5 in sync.decommit;
    # 10-12 in no span; 12-14 in vm.execute, which is its own phase
    assert got == {"decommit": (5.0, 2.0), "vm.execute": (2.0, 2.0)}
