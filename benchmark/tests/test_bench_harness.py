"""The harness on the CPU: it finds cells and metrics by name in files of
their own, runs a tiny cell end to end (set-up, window, metrics, the
judgement), and sees `correct` come out false when the timed path is
broken underneath. A tiny cell on two cards runs as two processes over
gloo, proves what one card proves, and ends at once when a rank fails."""

import copy
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

import harness
import ranks
from reference import tables, vm
from reference.check import reference_claim
from traffic import Traffic

ROOT = Path(harness.ROOT)
TINY = {"name": "tiny", "program": "+++>,<[>+.<-]", "input": [3],
        "prelude": {"gap": 4, "cells": 4}, "weight": 1}
# a second program of other table sizes, for a mix
LOOP = {"name": "loop", "program": ",[>++<-]>.", "input": [9], "prelude": {"gap": 3, "cells": 2},
        "weight": 2}


def _copy_root(tmp: Path) -> Path:
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp


def _claims(traffic: Traffic) -> dict:
    """Each entry's claim, from the reference's own tables."""
    out = {}
    for e in traffic.entries:
        src, inp = traffic.request(1, 0, e)
        code = vm.compile_program(src)
        out[e.name] = reference_claim(tables.all_tables(vm.run(code, inp)[0], code))
    return out


def _add_tiny_cell(root: Path, name="default.tiny", metric=None, traffic="tiny",
                   entries=(TINY,), chips=1) -> None:
    """A cell, its traffic and (optionally) a metric, as new files and new
    entries only."""
    spec = {"why": "a tiny mix for the tests", "requests": list(entries)}
    (root / f"benchmark/traffic/{traffic}.json").write_text(json.dumps(spec))
    claims = _claims(Traffic.from_json(traffic, spec))
    (root / f"benchmark/workloads/{name}.json").write_text(json.dumps(
        {"config": "default", "traffic": traffic, "chips": chips, "claims": claims,
         "warm_proves": 1, "checked_requests": 3, "traced_requests": 2}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "default", "traffic": traffic,
                               "chips": chips, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "production.fib19_io" in m["workloads"]:
            m["workloads"].append(name)
    if metric:
        (root / f"benchmark/metrics/{metric}.py").write_text(
            "def read(run):\n    return float(len(run.requests))\n")
        bench["per_layer"].append({"name": metric, "unit": "1", "better": "higher",
                                   "source": "program_counter", "layer": "request loop, host-paced",
                                   "moves": "prove_rate", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_every_name_in_benchmark_json_has_its_files():
    bench = harness.load_benchmark()
    names = harness.list_names()
    assert {w["name"] for w in bench["workloads"]} <= set(names["workloads"])
    assert {w["traffic"] for w in bench["workloads"]} <= set(names["traffic"])
    for m in bench["end_to_end"] + bench["per_layer"]:  # each has a reader, its own or its base's
        assert callable(harness.metric_reader(m["name"]))
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_a_new_cell_and_metric_are_found_from_new_files(tmp_path):
    root = _copy_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    _add_tiny_cell(root, metric="dummy.count")
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
    names = harness.list_names(root)
    assert "default.tiny" in names["workloads"] and "dummy.count" in names["metrics"]
    cell = harness.load_cell("default.tiny", root)
    assert "dummy.count" in {m["name"] for m in cell.per_layer}
    assert harness.metric_reader("dummy.count", root)(harness.Run(cell, 1, True)) == 0.0


def test_a_metric_without_a_reader_of_its_own_reads_with_its_base():
    assert harness.metric_reader("device.idle_share.default").__code__.co_filename == \
        harness.metric_reader("device.idle_share").__code__.co_filename.replace("\\", "/")
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("no_such_metric.default")


def test_every_seed_sends_the_same_requests_in_another_order():
    mix = Traffic.from_json("mix", {"requests": [TINY, LOOP]})
    orders = []
    for seed in (1, 2**31 + 7, 2**40 + 3):
        names = [mix.entry(seed, i).name for i in range(30)]
        for b in range(10):  # blocks of 3: tiny once, loop twice
            assert sorted(names[3 * b: 3 * b + 3]) == ["loop", "loop", "tiny"]
        orders.append(names)
        assert mix.request(seed, 4) != mix.request(seed, 5)
    assert orders[0] != orders[1] or orders[1] != orders[2]
    with pytest.raises(ValueError):
        Traffic.from_json("bad", {"requests": [TINY, TINY]})


def test_a_mix_of_programs_is_a_new_traffic_file_and_a_new_cell(tmp_path):
    """A cell of two programs, added as files only: set-up holds each
    entry to its own claim, the window sends both, the sample is judged
    against each request's claim."""
    root = _copy_root(tmp_path)
    _add_tiny_cell(root, name="default.tiny_mix", traffic="tiny_mix", entries=(TINY, LOOP))
    cell = harness.load_cell("default.tiny_mix", root)
    assert cell.claims["tiny"] != cell.claims["loop"]
    out = harness.run_cell("default.tiny_mix", 2**31 + 5, 2.0, False, "cpu", time.perf_counter(),
                           root=root)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    spec_path = root / "benchmark/workloads/default.tiny_mix.json"
    spec = json.loads(spec_path.read_text())
    spec["claims"]["loop"] = spec["claims"]["tiny"]
    spec_path.write_text(json.dumps(spec))
    with pytest.raises(harness.SetupError, match="loop"):
        harness.setup(harness.load_cell("default.tiny_mix", root), 3, "cpu")


def test_a_mix_sends_each_request_from_its_drawn_entry(tmp_path):
    root = _copy_root(tmp_path)
    _add_tiny_cell(root, name="default.tiny_mix", traffic="tiny_mix", entries=(TINY, LOOP))
    cell = harness.load_cell("default.tiny_mix", root)
    run = harness.Run(cell, 9, False)
    harness.window(run, "cpu", 1.0)
    assert run.requests
    for i, r in enumerate(run.requests):
        entry = cell.traffic.entry(9, i)
        src, inp = cell.traffic.request(9, i, entry)
        assert r.entry == entry.name
        assert r.steps == len(vm.run(vm.compile_program(src), inp)[0])


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = _copy_root(tmp_path_factory.mktemp("tiny"))
    _add_tiny_cell(root)
    _add_tiny_cell(root, name="default.tiny2", chips=2)
    return root


def _run(root, prove=harness.prove_request, trace=False, seconds=2.0):
    return harness.run_cell("default.tiny", 2**31 + 11, seconds, trace, "cpu",
                            time.perf_counter(), root=root, prove=prove)


def test_a_tiny_cell_runs_correct(tiny_root):
    out = _run(tiny_root)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    cell = harness.load_cell("default.tiny", tiny_root)
    # every end-to-end metric of the cell but the card's allocator peak
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end} - {"peak_mem_gb"}
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "checks" and all(c["limit"] == 0 for c in out["checks"].values())
    traced = _run(tiny_root, trace=True)
    assert traced["correct"] and "tables.ms" in traced["metrics"]
    assert "breakdown" in traced and "window_s" in traced["device"]


def _stale():
    """Each request after the first gets the proof of the one before."""
    held = {}

    def prove(cell, source, inp, device, timer=None):
        machine, proof, vm_s = harness.prove_request(cell, source, inp, device, timer)
        out = held.get("proof", proof)
        held["proof"] = proof
        return machine, copy.deepcopy(out), vm_s
    return prove


def _altered(cell, source, inp, device, timer=None):
    """A sampled value altered where the prover produces it."""
    machine, proof, vm_s = harness.prove_request(cell, source, inp, device, timer)
    v = proof["sampled_values"][2][0][0]
    v[0] = (v[0] + 1) % (2**31 - 1)
    return machine, proof, vm_s


def _half_openings(cell, source, inp, device, timer=None):
    """Half of the queried positions' openings left out of each tree."""
    machine, proof, vm_s = harness.prove_request(cell, source, inp, device, timer)
    for dec in proof["decommitments"]:
        for level, cols in dec["column_values"].items():
            dec["column_values"][level] = [c[: len(c) // 2] for c in cols]
    return machine, proof, vm_s


@pytest.mark.parametrize("fault", [_stale(), _altered, _half_openings],
                         ids=["state-unchanged", "answer-altered", "half-left-out"])
def test_a_broken_timed_path_is_not_correct(tiny_root, fault):
    out = _run(tiny_root, prove=fault)
    assert not out["correct"], out["checks"]


def test_run_py_refuses_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "default.fib19_io",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_py_fails_with_only_the_benchmark_files(tmp_path):
    root = _copy_root(tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "default.fib19_io",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "stwo_brainfuck_tpu_torch" in out.stderr


def test_the_control_is_not_correct(tiny_root):
    """The control (one query fewer than the configuration states, the
    proof labelled with the stated configuration) is rejected on every
    request; the sound proofs of the same requests pass."""
    import control

    cell = harness.load_cell("default.tiny", tiny_root)
    bad = control.judge_seed(cell, 3, "cpu",
                             control.prove_as(control.control_config(cell.config), cell.config))
    good = control.judge_seed(cell, 3, "cpu", harness.prove_request)
    assert bad["rejected"] == harness.sample_size(cell) and not any(good.values())


# ---------------------------------------------------------------------------
# A cell on several cards: one process a card (ranks.py), here gloo on the CPU
# ---------------------------------------------------------------------------

def test_a_one_card_cell_starts_no_process(tiny_root, monkeypatch):
    from stwo_brainfuck_tpu_torch.parallel import multihost

    def refuse(*args, **kwargs):
        raise AssertionError("a one-card cell joined a process group or started a process")

    monkeypatch.setattr(multihost, "initialize", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    out = _run(tiny_root, seconds=1.0)
    assert out["correct"] and out["device"] == {"count": 1, "memory_peak_bytes": 0}


def test_a_cell_on_two_cards_proves_what_one_card_proves(tiny_root, monkeypatch):
    kept = []
    judge = harness.judge

    def keeping(run, device):
        kept.extend(run.kept)
        return judge(run, device)

    monkeypatch.setattr(harness, "judge", keeping)
    seed = 2**31 + 13
    out = harness.run_cell("default.tiny2", seed, 2.0, False, "cpu", time.perf_counter(),
                           root=tiny_root)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["device"]["count"] == 2 and len(out["device"]["memory_peak_bytes_by_card"]) == 2
    assert kept and len(kept) == min(out["attempted"], 3)
    one = harness.load_cell("default.tiny", tiny_root)
    for k in kept:
        assert (k.source, k.input) == one.traffic.request(seed, k.index)
        _machine, proof, _ = harness.prove_request(one, k.source, k.input, "cpu")
        assert json.dumps(k.proof, sort_keys=True) == json.dumps(proof, sort_keys=True)


_RANK0 = """
import json, sys, time
from pathlib import Path
sys.path[:0] = {path!r}
import harness
out = harness.run_cell("default.tiny2", 2**31 + 17, 60.0, False, "cpu", time.perf_counter(),
                       root=Path({root!r}))
print(json.dumps(out))
"""


def _gone(pid: int) -> bool:
    """No process `pid`, or only its exit status left (state Z)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


@pytest.mark.parametrize("ending", ["worker-killed", "rank-0-terminated"])
def test_a_failing_rank_ends_the_run(tiny_root, ending):
    """A worker killed in the window ends rank 0 within a minute, non-zero
    and with no result line; rank 0 ended by SIGTERM takes its worker
    with it. Standard error reaches its end only when every process that
    holds it (rank 0 and its worker) has ended."""
    code = _RANK0.format(path=[str(harness.BENCH_DIR), str(harness.ROOT)], root=str(tiny_root))
    rank0 = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        worker, head = None, []
        for line in rank0.stderr:
            head.append(line)
            m = re.match(r"rank 1: pid (\d+)", line)
            worker = int(m.group(1)) if m else worker
            if "the window opens" in line:
                break
        assert worker is not None, "".join(head)
        time.sleep(0.5)
        t0 = time.monotonic()
        if ending == "worker-killed":
            os.kill(worker, signal.SIGKILL)
        else:
            os.kill(rank0.pid, signal.SIGTERM)
        out, err = rank0.communicate(timeout=ranks.STALL_S)
        assert time.monotonic() - t0 < ranks.STALL_S
    finally:
        if rank0.poll() is None:
            rank0.kill()
            rank0.wait()
    assert rank0.returncode != 0 and out.strip() == ""
    assert _gone(worker)
    if ending == "worker-killed":
        assert "rank 1 exited with code -9" in err, err[-3000:]
    else:
        assert "rank 0 has ended" in err, err[-3000:]


def test_the_cards_readings_combine_as_the_fullest_card_and_the_mean_idle_share():
    cell = harness.load_cell("production.fib19_io")

    def run_of(peak, phases, busy, window):
        run = harness.Run(cell, 1, True)
        run.peak_bytes = peak
        run.traced = harness.TraceData(window_s=window, busy_s=busy, requests=1,
                                       phase_peaks=phases)
        return run

    def reading(name, run):
        return harness.metric_reader(name)(run)

    cards = [run_of(5 * 10**9, {"tree1": 4 * 10**9, "fri": 1 * 10**9}, 2.0, 10.0),
             run_of(7 * 10**9, {"tree1": 3 * 10**9, "fri": 6 * 10**9}, 6.0, 12.0),
             run_of(6 * 10**9, {"tree1": 2 * 10**9}, 4.0, 8.0)]
    readings = [ranks.card_readings(c) for c in cards]
    alone = run_of(5 * 10**9, {"tree1": 4 * 10**9, "fri": 1 * 10**9}, 2.0, 10.0)
    ranks.combine(alone, readings[:1])  # one card: every reading as it was
    assert (reading("peak_mem_gb", alone), reading("mem.fri_gb", alone),
            reading("device.idle_share", alone)) == (5.0, 1.0, 80.0)
    assert alone.peak_by_card == [5 * 10**9]
    rank0 = cards[0]
    ranks.combine(rank0, readings)
    assert rank0.peak_by_card == [5 * 10**9, 7 * 10**9, 6 * 10**9]
    assert reading("peak_mem_gb", rank0) == 7.0
    assert (reading("mem.commit_gb", rank0), reading("mem.fri_gb", rank0)) == (4.0, 6.0)
    # idle shares 80 %, 50 % and 50 %, each of its card's own traced window
    assert reading("device.idle_share", rank0) == pytest.approx(60.0)
    assert rank0.traced.window_s == 10.0


def test_the_ranks_share_out_the_cores():
    assert ranks.core_sets(range(32), 4) == [list(range(28, 32)), list(range(24, 28)),
                                             list(range(20, 24)), list(range(16, 20))]
    assert ranks.core_sets(range(8), 1) == [[4, 5, 6, 7]]
    assert ranks.core_sets(range(8), 4) == [[4, 5, 6, 7]] * 4
