"""The port's VM CLI (python -m stwo_brainfuck_tpu_torch.vm.cli) against the
JAX package's: the same stdout and stderr, byte for byte, and the same exit
codes."""

import io
import os
import subprocess
import sys

import pytest

from stwo_brainfuck_tpu.vm import cli as jcli
from stwo_brainfuck_tpu_torch.vm import cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = "++++++[>++++++++<-]>+.,[>+<-]>.<<+++[-]"


def _run(module, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                         capture_output=True, timeout=120)
    return res.returncode, res.stdout, res.stderr


def test_vm_cli_matches_jax_cli(tmp_path):
    path = tmp_path / "prog.bf"
    path.write_text(PROGRAM)
    args = [str(path), "--trace", "--memory", "--input", "A"]
    port = _run("stwo_brainfuck_tpu_torch.vm.cli", *args)
    ref = _run("stwo_brainfuck_tpu.vm.cli", *args)
    assert port == ref
    assert port[0] == 0 and port[1] == b"1A"
    assert b"[Memory] [0, 0, 65]" in port[2]


def _in_process(main, argv, stdin, capsysbinary, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(stdin)))
    rc = main(argv)
    out = capsysbinary.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("case", ["stdin_input", "ram_size", "unmatched", "missing_file",
                                  "input_eof"])
def test_vm_cli_cases_match_jax(case, tmp_path, capsysbinary, monkeypatch):
    path = tmp_path / "p.bf"
    path.write_text({"unmatched": "+[", "input_eof": ",,"}.get(case, PROGRAM))
    argv = {"stdin_input": [str(path), "--memory"],
            "ram_size": [str(path), "--memory", "--ram-size", "3", "--input", "B"],
            "missing_file": [str(tmp_path / "none.bf")]}.get(case, [str(path), "--input", "x"])
    port = _in_process(tcli.main, argv, b"C", capsysbinary, monkeypatch)
    ref = _in_process(jcli.main, argv, b"C", capsysbinary, monkeypatch)
    assert port == ref
    assert port[0] == (2 if case in ("unmatched", "missing_file", "input_eof") else 0)
