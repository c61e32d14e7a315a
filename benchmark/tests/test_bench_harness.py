"""The harness on the CPU: it finds cells and metrics by name in files of
their own, runs a tiny cell end to end (set-up, window, metrics, the
judgement), and sees `correct` come out false when the timed path is
broken underneath."""

import copy
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

import harness
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
                   entries=(TINY,)) -> None:
    """A cell, its traffic and (optionally) a metric, as new files and new
    entries only."""
    spec = {"why": "a tiny mix for the tests", "requests": list(entries)}
    (root / f"benchmark/traffic/{traffic}.json").write_text(json.dumps(spec))
    claims = _claims(Traffic.from_json(traffic, spec))
    (root / f"benchmark/workloads/{name}.json").write_text(json.dumps(
        {"config": "default", "traffic": traffic, "chips": 1, "claims": claims, "warm_proves": 1,
         "checked_requests": 3, "traced_requests": 2}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": name, "config": "default", "traffic": traffic, "chips": 1,
                               "why": "tests"})
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
