"""The port's bench (stwo_brainfuck_tpu_torch/bench.py): the output contract
of tests/test_bench_contract.py (one final line, valid JSON, under 2000
characters with every suite row present, printed exactly once, never
without a headline; big22 first after the headline with the largest
reserve), a CPU run of the small program against the JAX package's recorded
sha256, child rows that run out of memory or die (retried once, then
recorded), SIGTERM during the suite, and no run without a card unless the
CPU is asked for."""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from stwo_brainfuck_tpu_torch import bench
from stwo_brainfuck_tpu_torch.components import device_build
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPROCESS_TIMEOUT_S = 240


def _fake_row(**over):
    row = {
        "program": "fib19_io", "input": [19], "config": "default", "steps": 223689,
        "trace_ms": 17.5, "cold_prove_s": 1.1486792230000447,
        "cold_phases_s": {"tables": 0.12, "quotients": 0.11},
        "warm_prove_s": 0.5252561190000051,
        "warm_runs_s": [0.5252561190000051, 0.5933059660000026, 0.6011],
        "total_s": 0.5427561190000051, "khz": 412.13456789, "proof_bytes": 515641,
        "sha256": bench.REFERENCE_SHA256["fib19_io"], "matches_jax": True, "verified": True,
        "verify_s": 0.10229129800001147, "fresh_verify_s": 10.816975877999994,
        "cold_peak_bytes": 2644977152, "warm_peak_bytes": 2757372416,
        "kernel_launches": {"fft": 35, "tree": 13, "level": 0, "grind": 0},
    }
    row.update(over)
    return row


def _report(tmp_path, planned=None):
    headline = bench.ROWS["fib19_io"]
    return bench.Report(headline, planned or [headline.name, *bench.SUITE], 1500.0,
                        "NVIDIA H100 80GB HBM3, 700.00 W", str(tmp_path / "suite.json"),
                        time.time())


def test_final_line_is_single_compact_json(tmp_path):
    spread = ["fib19_io_d4", "fib19_io_w4"]
    report = _report(tmp_path, ["fib19_io", *bench.SUITE, *spread])
    report.record("fib19_io", _fake_row())
    report.record("big22", {
        "error": "OutOfMemoryError: CUDA out of memory. Tried to allocate 8.00 GiB. GPU 0 has a "
                 "total capacity of 79.19 GiB of which 2.06 GiB is free." * 3,
        "oom": True, "stage": "cold prove: quotients", "peak_bytes": 79123456789, "attempts": 2})
    report.record("small", _fake_row(program="small", khz=3.14159265))
    report.record("fib19_io_production", {"skipped": "budget (12 s left, need 240 s)"})
    report.record("fib19_io_in16_production", {"error": "a child process exited -9 without a "
                                                        "result line: " + "x" * 300})
    report.record("fib19_io_d4", _fake_row(shards=4))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert report.emit("skipped: fib19_io_production")
        assert not report.emit()  # the second call prints nothing
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1, "the final line is printed exactly once"
    assert len(lines[0]) < 2000, f"final line of {len(lines[0])} characters"
    line = json.loads(lines[0])
    assert line["metric"] == "fib19_io.bf prove wall-clock (trace+proof, warm)"
    assert line["value"] == pytest.approx(0.5427561190000051, rel=1e-5)
    assert line["unit"] == "s"
    assert line["sha256"] == bench.REFERENCE_SHA256["fib19_io"] and line["verified"] is True
    assert len(line["warm_runs_s"]) == 3 and line["peak_bytes"] == 2757372416
    assert line["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert "vs_baseline" not in line  # no H100 baseline exists to be relative to
    for key in ("steps", "proof_khz", "cold_prove_s", "verify_s", "fresh_verify_s",
                "proof_bytes", "elapsed_s", "budget_s", "partial"):
        assert key in line
    # every row but the headline, the one not reached included
    assert set(line["suite"]) == set(bench.SUITE) | set(spread)
    assert line["suite"]["fib19_io_w4"] == {"skipped": "not reached"}
    assert line["suite"]["big22"]["peak"] == 79123456789
    assert line["suite"]["big22"]["stage"] == "cold prove: quotients"
    with open(tmp_path / "suite.json") as f:
        detail = json.load(f)
    assert detail["rows"]["big22"]["attempts"] == 2
    assert set(detail["rows"]) == {"fib19_io", *bench.SUITE, *spread}


def test_emit_without_headline_is_noop(tmp_path):
    report = _report(tmp_path)
    report.record("fib19_io", {"error": "BenchError: sha256 mismatch"})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert not report.emit()
    assert buf.getvalue() == ""
    assert not report.emitted


def test_suite_order_attempts_big22_first():
    assert bench.SUITE[0] == "big22"
    assert bench.RESERVE_S["big22"] >= max(
        [v for k, v in bench.RESERVE_S.items() if k != "big22"] + [bench.DEFAULT_RESERVE_S])
    assert set(bench.SUITE) <= set(bench.ROWS)
    assert [n for n in bench.SUITE if bench.ROWS[n].isolated] == [
        "big22", "fib19_io_production", "fib19_io_in16_production"]


def test_production_row_input_has_a_2_18_table():
    """The second production row's input gives fib19_io a largest table of
    2^18 rows (its composition is committed at 2^26 leaves)."""
    row = bench.ROWS["fib19_io_in16_production"]
    machine = create_test_machine(compile_program(row.source()), row.input)
    machine.execute()
    claim = device_build.build_meta(machine.trace(), machine.program()).claim
    assert max(claim.values()) == 18 and len(machine.trace()) == 52931
    assert max(claim.values()) + 2 * bench.CONFIGS[row.config].log_blowup == 26


def test_run_program_small_on_cpu():
    result = bench.run_program(bench.ROWS["small"], "cpu", bench.Children())
    assert result["sha256"] == bench.REFERENCE_SHA256["small"]
    assert result["matches_jax"] is True and result["verified"] is True
    assert len(result["warm_runs_s"]) == bench.WARM_RUNS >= 3
    assert result["warm_prove_s"] == min(result["warm_runs_s"])
    assert result["steps"] == 26 and result["cold_peak_bytes"] is None
    assert list(result["cold_phases_s"]) == list(bench.air.PHASES)
    assert result["fresh_verify_s"] > result["fresh_verify_call_s"] > 0


def _bench_env(**extra):
    env = dict(os.environ, BENCH_PROGRAM="small", **extra)
    for key in ("BENCH_DEVICE", "BENCH_DEVICES", "BENCH_DISTRIBUTED", "BENCH_CONFIG"):
        env.pop(key, None)
    return env


def _bench_children() -> list:
    """Child processes (--one) of any bench still alive."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
        except OSError:
            continue
        if b"stwo_brainfuck_tpu_torch.bench" in cmd and b"--one" in cmd:
            found.append(int(pid))
    return found


def test_child_out_of_memory_is_retried_and_recorded(tmp_path):
    suite = tmp_path / "suite.json"
    res = subprocess.run(
        [sys.executable, "-m", "stwo_brainfuck_tpu_torch.bench", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S,
        env=_bench_env(BENCH_CHILD_FAULT="oom", BENCH_SUITE_PATH=str(suite)))
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["sha256"] == bench.REFERENCE_SHA256["small"]
    with open(suite) as f:
        rows = json.load(f)["rows"]
    for name in ("big22", "fib19_io_production", "fib19_io_in16_production"):
        assert line["suite"][name]["error"].startswith("OutOfMemoryError"), line["suite"]
        assert rows[name]["oom"] is True and rows[name]["attempts"] == 2
        assert rows[name]["stage"] == "start"
    assert set(line["suite"]) == set(bench.SUITE) - {"small"}  # the headline is not a row


def test_child_without_a_line_is_retried_then_an_error(monkeypatch):
    monkeypatch.setenv(bench.FAULT_ENV, "die")
    result = bench.run_isolated(bench.ROWS["big22"], torch.device("cpu"), bench.Children(),
                                timeout=SUBPROCESS_TIMEOUT_S)
    assert result["attempts"] == 2
    assert result["error"].startswith("a child process exited 3 without a result line")


def test_sigterm_during_the_suite_prints_the_line_once(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "stwo_brainfuck_tpu_torch.bench", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_bench_env(BENCH_CHILD_FAULT="hang", BENCH_SUITE_PATH=str(tmp_path / "s.json")))
    try:
        for line in proc.stderr:
            if line.startswith("# small:"):  # the headline is done; big22 hangs
                break
        time.sleep(3)  # the big22 child has started
        assert _bench_children(), "the big22 child should be running"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["partial"].startswith(f"signal {int(signal.SIGTERM)}")
    assert set(line["suite"]) == set(bench.SUITE) - {"small"}
    assert line["suite"]["big22"] == {"skipped": f"not reached: signal {int(signal.SIGTERM)}"}
    assert not _bench_children(), "the child process outlived the bench"


@pytest.mark.parametrize("env,args", [({}, []), ({"BENCH_PROGRAM": "m31"}, ["--device", "cpu"])],
                         ids=["no-card", "micro-mode-on-cpu"])
def test_bench_refuses_to_run_without_a_card(env, args):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    res = subprocess.run([sys.executable, "-m", "stwo_brainfuck_tpu_torch.bench", *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**_bench_env(), **env})
    assert res.returncode != 0
    assert res.stdout == ""
    assert len(res.stderr.strip().splitlines()) == 1, res.stderr
