"""The port's table build on the device (components/device_build.py) vs the
JAX package's and vs the port's host builders, on the CPU, bit for bit:
build_meta field by field, and every component matrix."""

import os

import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.components import device_build as jbuild
from stwo_brainfuck_tpu.vm.compiler import compile_program as jcompile
from stwo_brainfuck_tpu.vm.machine import create_test_machine as jmachine
from stwo_brainfuck_tpu_torch import air
from stwo_brainfuck_tpu_torch.components import device_build as tbuild
from stwo_brainfuck_tpu_torch.components import tables as ttables
from stwo_brainfuck_tpu_torch.components.defs import COMPONENT_CLASSES
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program as tcompile
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine as tmachine

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

with open(os.path.join(ROOT, "programs", "fib19_io.bf")) as _f:
    FIB19_IO = _f.read()

# the programs of tests/test_device_build.py, and fib19_io at a small input
PROGRAMS = {
    "io_loop": ("+++>,<[>+.<-]", b"\x01"),
    "no_jumps": ("+++.", b""),
    "empty_ops": (",.", b"\x05"),
    "fib-ish": ("++>+<[->>+>+<<<]", b""),
    "fib19_io": (FIB19_IO, bytes([5])),
}


def _trace(name):
    code, inp = PROGRAMS[name]
    m = tmachine(tcompile(code), inp)
    m.execute()
    return m.trace(), m.program()


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_build_meta_matches_jax(name):
    trace, program = _trace(name)
    code, inp = PROGRAMS[name]
    jm = jmachine(jcompile(code), inp)
    jm.execute()
    np.testing.assert_array_equal(trace, jm.trace())
    tm = tbuild.build_meta(trace, program)
    jmeta = jbuild.build_meta(jm.trace(), jm.program())
    assert list(tm.claim.items()) == list(jmeta.claim.items())
    assert tuple(tm.claim) == air.CLAIM_ORDER
    assert (tm.n_steps, tm.plen, tm.k) == (jmeta.n_steps, jmeta.plen, jmeta.k)
    for field in ("order_mem", "counts_mem", "order_ins", "prog_cols", "eoe_cols"):
        got, want = getattr(tm, field), getattr(jmeta, field)
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert list(tm.sel) == list(jmeta.sel)
    for key in jmeta.sel:
        np.testing.assert_array_equal(tm.sel[key], jmeta.sel[key], err_msg=key)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_device_tables_match_jax_and_host_builders(name):
    trace, program = _trace(name)
    meta = tbuild.build_meta(trace, program)
    mats = tbuild.build_device_tables(trace, meta, "cpu")
    jmats = jbuild.build_device_tables(trace, jbuild.build_meta(trace, program))
    host = ttables.all_tables(trace, program)
    assert list(mats) == list(air.CLAIM_ORDER)
    for cls in COMPONENT_CLASSES:
        comp = cls(meta.claim[cls.name])
        got = mats[comp.name]
        assert got.dtype == torch.int32 and got.is_contiguous(), comp.name
        want = np.stack([host[comp.name][c] for c in comp.columns])
        assert got.shape == want.shape == (len(comp.columns), 1 << comp.log_size), comp.name
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want, err_msg=comp.name)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(jmats[comp.name]), err_msg=comp.name)
