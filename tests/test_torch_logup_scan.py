"""The LogUp scan kernel's schedule, held on the CPU (the CUDA kernel runs
only on a card: tests/test_torch_gpu.py).

- Its emulation (ops/constraint_kernels.emulate_scan: the pairs and their
  mirrors as the lanes read them, the warps' and tiles' sums, the tiles'
  chain, the column totals scanned in key order) equals the plain prefix
  sum (framework.prefix_sum_plain) at 2^2 .. 2^16 rows, on random and edge
  values.
- Fed the logup kernel's emulated row sums, it gives the S column and the
  claimed sum of build_interaction_trace's torch path and of the JAX
  package's build_interaction_trace for several components at 2^4 .. 2^16.
- The linear mode with a carry, chained over chunks, equals
  parallel/sharded.prefix_sum on CPU meshes of 2, 4 and 8 shards.
- The geometry covers every pair once; the bound's bytes; the wrapper
  refuses CPU tensors before loading the library.
Tolerance: none, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stwo_brainfuck_tpu.components import defs as jdefs
from stwo_brainfuck_tpu.framework import component as jfw
from stwo_brainfuck_tpu_torch import convert
from stwo_brainfuck_tpu_torch.components import defs as tdefs
from stwo_brainfuck_tpu_torch.core.fft import coset_order_permutation
from stwo_brainfuck_tpu_torch.framework import component as tfw
from stwo_brainfuck_tpu_torch.ops import constraint_kernels as ck
from stwo_brainfuck_tpu_torch.parallel import sharded
from stwo_brainfuck_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)
P = 2**31 - 1
EDGE = np.array([0, 1, P - 2, P - 1])


def _rows(seed: int, n: int, edge: bool = False) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = EDGE[rng.integers(0, 4, (4, n))] if edge else rng.integers(0, P, (4, n))
    return torch.as_tensor(x.astype(np.int32))


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("log_n", range(2, 17))
def test_scan_emulation_equals_the_plain_prefix_sum(log_n, edge):
    total = _rows(log_n, 1 << log_n, edge)
    s, claimed = ck.emulate_scan(total)
    want, want_claimed = tfw.prefix_sum_plain(total, coset_order_permutation(log_n, "cpu"))
    assert torch.equal(s, want) and torch.equal(claimed, want_claimed)
    # the CPU dispatch is the plain version
    got, got_claimed = tfw.prefix_sum(total)
    assert torch.equal(got, want) and torch.equal(got_claimed, want_claimed)


def _elements(fw, seed):
    rng = np.random.default_rng(seed)

    def felt():
        return tuple(int(v) for v in rng.integers(0, P, 4))

    return {k: fw.LookupElements(z=felt(), alpha=felt(), size=s)
            for k, s in jdefs.ELEMENT_SIZES.items()}


@pytest.mark.parametrize("name, log", [("memory", 4), ("processor", 10), ("instruction", 16),
                                       ("jump_if_zero", 8), ("output_instruction", 12)])
def test_scan_gives_the_interaction_trace_of_both_packages(name, log):
    tcls = next(c for c in tdefs.COMPONENT_CLASSES if c.name == name)
    jcls = next(c for c in jdefs.COMPONENT_CLASSES if c.name == name)
    rng = np.random.default_rng(log)
    cols = {c: rng.integers(0, P, 1 << log, dtype=np.uint32) for c in tcls(log).columns}
    comp = tcls(log)
    main = {c: convert.to_torch(v) for c, v in cols.items()}
    is_first = torch.zeros(1 << log, dtype=torch.int32)
    is_first[0] = 1
    _, total = ck.emulate_logup(comp, main, is_first, _elements(tfw, log))
    s, claimed = ck.emulate_scan(total)
    torch_cols, torch_claimed = tfw.build_interaction_trace(comp, main, _elements(tfw, log))
    assert torch.equal(s, torch_cols[-1])
    assert tuple(int(v) for v in claimed) == torch_claimed
    want, want_claimed = jfw.build_interaction_trace(
        jcls(log), {c: jnp.asarray(v) for c, v in cols.items()}, _elements(jfw, log))
    np.testing.assert_array_equal(convert.to_numpy(s), np.asarray(want[-1]))
    assert tuple(int(v) for v in claimed) == tuple(want_claimed)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_linear_scan_with_carries_equals_the_mesh_prefix_sum(d):
    n = 1 << 13
    x = _rows(d, n)
    mesh = make_mesh(d, "cpu")
    out, claimed = sharded.prefix_sum(mesh, mesh.shard(x).shards)
    carry = None
    c = n // d
    for i in range(d):
        s, carry = ck.emulate_scan(x[:, i * c:(i + 1) * c].contiguous(), False, carry)
        assert torch.equal(s, out[i])
    assert torch.equal(carry, claimed)
    want, want_claimed = tfw.prefix_sum_plain(x)
    assert torch.equal(torch.cat(out, 1), want) and torch.equal(claimed, want_claimed)


@pytest.mark.parametrize("n", [1, 31, 2047, 2048, 2049, 5000])
def test_linear_scan_emulation_with_a_carry(n):
    x = _rows(n, n)
    carry = torch.as_tensor(np.random.default_rng(n).integers(0, P, 4).astype(np.int32))
    for c in (None, carry):
        s, last = ck.emulate_scan(x, False, c)
        want, want_last = tfw.prefix_sum_plain(x, None, c)
        assert torch.equal(s, want) and torch.equal(last, want_last)


@pytest.mark.parametrize("log_n", range(2, 31))
def test_scan_geometry_covers_every_pair_once(log_n):
    col_log, row_log, tile_rows, tiles, rpw = ck.scan_geometry(log_n)
    assert col_log + row_log == log_n - 1 and col_log <= 5
    # a tile's rows of the chain's first half, as many mirrors: every pair once
    assert 2 * tiles * tile_rows == 1 << row_log
    assert (rpw * 8 == tile_rows) if tile_rows >= 8 else rpw == 1
    assert tiles == min(64, max(1, (1 << (row_log - 1)) // 32))


def test_scan_bound_and_refusals():
    comp = tdefs.COMPONENT_CLASSES[0](20)
    nbytes, products, adds = ck.launch_work(comp, "scan", 1 << 20)
    assert (nbytes, products, adds) == (32 << 20 | 16, 0, 4 * ((1 << 20) - 1))
    x = _rows(0, 64)
    with pytest.raises(ValueError):
        ck.KERNELS.scan(x)  # a CPU tensor: refused before the library loads
    with pytest.raises(TypeError):
        ck.KERNELS.scan(x.to(torch.int64))
    with pytest.raises(ValueError):
        ck.KERNELS.scan(x[:, :48].contiguous())
    with pytest.raises(ValueError):
        ck.KERNELS.scan(x, True, x[:, 0].contiguous())
    assert ck.KERNELS.scan_lib._lib is None
