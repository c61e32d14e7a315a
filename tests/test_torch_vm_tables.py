"""The port's VM traces and 13 table builders vs the JAX package's, on
programs held in the repo (inline sources and programs/*.bf)."""

import os

import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.components import tables as jtables
from stwo_brainfuck_tpu.vm.compiler import compile_program as jcompile
from stwo_brainfuck_tpu.vm.machine import create_test_machine as jmachine
from stwo_brainfuck_tpu_torch.components import tables as ttables
from stwo_brainfuck_tpu_torch.vm import native
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program as tcompile
from stwo_brainfuck_tpu_torch.vm.machine import Machine, create_test_machine as tmachine

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROGRAMS = [
    ("+++>,<[>+.<-]", b"\x01"),
    ("++[-]+.", b""),
    ("+>,<[>+.<-]+.", b"\x02"),
    ("++++[>++<-]>[<+>-]<.", b""),
]


def _read(name):
    with open(os.path.join(ROOT, "programs", name)) as f:
        return f.read()


def _run(make, compile_fn, code, inp):
    m = make(compile_fn(code), inp)
    m.execute()
    return m


@pytest.mark.parametrize("code,inp", PROGRAMS + [(_read("fib19_io.bf"), bytes([5]))])
def test_traces_and_tables_match_jax(code, inp):
    mj = _run(jmachine, jcompile, code, inp)
    mt = _run(tmachine, tcompile, code, inp)
    assert tcompile(code) == jcompile(code)
    np.testing.assert_array_equal(mt.trace(), mj.trace())
    assert mt.output_bytes() == mj.output_bytes()
    tj = jtables.all_tables(mj.trace(), mj.program())
    tt = ttables.all_tables(mt.trace(), mt.program())
    assert list(tt) == list(tj) and len(tt) == 13
    for name in tj:
        assert list(tt[name]) == list(tj[name])
        for col in tj[name]:
            np.testing.assert_array_equal(tt[name][col], tj[name][col], err_msg=f"{name}/{col}")


def test_python_vm_matches_native_vm():
    code, inp = PROGRAMS[0]
    fast = _run(tmachine, tcompile, code, inp)
    slow = Machine(tcompile(code), input_data=inp)
    slow._execute_python()
    np.testing.assert_array_equal(fast.trace(), slow.trace())
    assert fast.vm == ("native" if native.available() else "python")


def test_big22_trace_matches_jax():
    """programs/big22.bf (1.32 M steps) traced by both packages; its tables
    (2^22 rows) are left to the chip smoke run."""
    src = _read("big22.bf")
    mj = _run(jmachine, jcompile, src, b"")
    mt = _run(tmachine, tcompile, src, b"")
    assert len(mt.trace()) == 1_323_044
    np.testing.assert_array_equal(mt.trace(), mj.trace())


def test_native_library_builds_in_package_build_dir():
    lib = native._build()
    if lib is None:
        pytest.skip("no C++ compiler")
    assert lib.parent.name == "build" and lib.parent.parent.name == "stwo_brainfuck_tpu_torch"
