"""The interaction kernel's schedule, held on the CPU (the CUDA kernel runs
only on a card: tests/test_torch_gpu.py).

- Its emulation (ops/constraint_kernels.emulate_interaction: each lane's
  pair row and its mirror, the four storage rows' fractions in batches of
  B rows with their norms inverted together, zero norms included, the
  tiles of the coset scan, the look-back's chain and the column totals)
  equals framework.interaction_plain for all 13 components at log sizes
  2 .. 16, and the JAX package's _build_interaction_fn (through its
  build_interaction_trace, on JAX's CPU backend) at one of those sizes a
  component (2 .. 16 over the 13), on random values and on edge values (0,
  1, p - 2, p - 1, the lookup elements' z moved so that denominators are
  0).
- The emitted bodies' split (denominators, then the fractions from given
  inverses) with batched inversion equals the per-value QM31 inverse for
  every component and batch size, with zero denominators.
- The geometry covers every pair of storage rows exactly once at log sizes
  2 .. 30; the bound's counts; the wrapper refuses CPU tensors before it
  loads the library.
Tolerance: none, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stwo_brainfuck_tpu.components import defs as jdefs
from stwo_brainfuck_tpu.framework import component as jfw
from stwo_brainfuck_tpu_torch import convert
from stwo_brainfuck_tpu_torch.components import defs as tdefs
from stwo_brainfuck_tpu_torch.framework import component as tfw
from stwo_brainfuck_tpu_torch.ops import constraint_codegen as cg
from stwo_brainfuck_tpu_torch.ops import constraint_kernels as ck

torch.set_num_threads(1)
P = 2**31 - 1
EDGE = np.array([0, 1, P - 2, P - 1])
NAMES = [c.name for c in tdefs.COMPONENT_CLASSES]
T_CLASSES = {c.name: c for c in tdefs.COMPONENT_CLASSES}
J_CLASSES = {c.name: c for c in jdefs.COMPONENT_CLASSES}


def _case(name, log, seed, edge):
    """numpy main columns and host lookup elements (z moved on edge
    values so that relation k's denominator is 0 at some storage rows)."""
    rng = np.random.default_rng(seed)
    n = 1 << log
    cols = {c: (EDGE[rng.integers(0, 4, n)] if edge else rng.integers(0, P, n)).astype(np.uint32)
            for c in T_CLASSES[name].columns}

    def felt():
        return tuple(int(v) for v in rng.integers(0, P, 4))

    els = {k: (felt(), felt(), s) for k, s in jdefs.ELEMENT_SIZES.items()}
    if edge:
        tels = {k: tfw.LookupElements(z=z, alpha=a, size=s) for k, (z, a, s) in els.items()}
        main = {c: convert.to_torch(v) for c, v in cols.items()}
        moved = chip_smoke.zero_den_elements(T_CLASSES[name](log), main, tels,
                                             [0, n - 1, n // 2, 1])
        els = {k: (e.z, e.alpha, e.size) for k, e in moved.items()}
    return cols, els


def _elements(fw, els):
    return {k: fw.LookupElements(z=z, alpha=a, size=s) for k, (z, a, s) in els.items()}


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_emulated_schedule_equals_the_plain_interaction(name, edge):
    for log in range(2, 17):
        cols, els = _case(name, log, log + 100 * edge, edge)
        comp = T_CLASSES[name](log)
        main = {c: convert.to_torch(v) for c, v in cols.items()}
        want = tfw.interaction_plain(comp, main, _elements(tfw, els))
        # tiles for an H100 at two CTAs an SM, for one SM, and for 7 CTAs
        for max_tiles, batch in ((264, 4), (1, 2), (7, 1)):
            got = ck.emulate_interaction(comp, main, _elements(tfw, els), max_tiles, batch)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (log, max_tiles, batch)
        # the CPU dispatch of the one-device path is the plain version
        cols_t, claimed = tfw.build_interaction_trace_async(comp, main, _elements(tfw, els))
        assert torch.equal(torch.stack(cols_t[:-1]), want[0]) and torch.equal(cols_t[-1], want[1])
        assert torch.equal(claimed, want[2])


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_emulated_schedule_equals_the_jax_interaction(name, edge):
    log = 2 + NAMES.index(name) * 14 // 12  # 2 .. 16 over the 13 components
    cols, els = _case(name, log, 7 * log + edge, edge)
    comp = T_CLASSES[name](log)
    q, s, claimed = ck.emulate_interaction(
        comp, {c: convert.to_torch(v) for c, v in cols.items()}, _elements(tfw, els))
    want, want_claimed = jfw.build_interaction_trace(
        J_CLASSES[name](log), {c: jnp.asarray(v) for c, v in cols.items()},
        _elements(jfw, els))
    assert len(want) == q.shape[0] + 1
    for g, w in zip([*q, s], want):
        np.testing.assert_array_equal(convert.to_numpy(g), np.asarray(w))
    assert tuple(int(v) for v in claimed) == tuple(want_claimed)


@pytest.mark.parametrize("batch", [1, 2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_batched_inverse_split_equals_the_qm31_inverse(name, batch):
    """emulate_fractions (the emitted split: denominators, norms inverted
    in batches, fractions from the inverses) against the program's
    fractions with each denominator inverted on its own (core/qm31.py inv,
    the kernel's qm31::qm_inv), with zero denominators in the batches."""
    log = 8
    cols, els = _case(name, log, batch, True)
    comp = T_CLASSES[name](log)
    main = {c: convert.to_torch(v) for c, v in cols.items()}
    is_first = (torch.arange(1 << log) == 0).to(torch.int64)
    program = tfw.constraint_program(T_CLASSES[name])
    vals = tfw.emulate(program, {"cols": [main[c] for c in comp.columns], "is_first": is_first,
                                 "elements": _elements(tfw, els)}, program.fractions)
    want = torch.stack([vals[f] for f in program.fractions])
    dens = tfw.emulate(program, {"cols": [main[c] for c in comp.columns], "is_first": is_first,
                                 "elements": _elements(tfw, els)},
                       [d for d, _ in program.inversions()])
    assert any(bool((dens[d] == 0).all(0).any()) for d, _ in program.inversions())
    order = torch.arange(1 << log).reshape(-1, 4)  # a thread's 4 rows
    got = ck.emulate_fractions(comp, main, is_first, _elements(tfw, els), order, batch)
    assert torch.equal(got.reshape(want.shape), want)
    # the emitted bodies: the denominators' and the fractions' statements
    body = cg.emit_component(T_CLASSES[name])
    for k, (d, i) in enumerate(program.inversions()):
        assert f"den[{k}] = v{d};" in body and f"const Qm v{i} = inv[{k}];" in body
    assert "qm_inv(" not in body


@pytest.mark.parametrize("log_n", range(2, 31))
def test_geometry_covers_every_pair_once(log_n):
    """Every storage row in exactly one lane's four (2j, 2j + 1, N - 2 - 2j,
    N - 1 - 2j), at 1, 7, 132, 264 and 1056 resident tiles: enumerated up
    to 2^20 rows, counted beyond."""
    n = 1 << log_n
    for max_tiles in (1, 7, 132, 264, 1056):
        col_log, row_log, tile_rows, tiles, rpw = ck.scan_geometry(log_n, max_tiles)
        assert tiles * tile_rows * (1 << col_log) * 4 == n and tiles <= max_tiles
        if log_n > 20:
            continue
        u, rho, lane = torch.meshgrid(torch.arange(tiles), torch.arange(tile_rows),
                                      torch.arange(1 << col_log), indexing="ij")
        kr = u * tile_rows + rho
        assert int(kr.max()) < 1 << (row_log - 1)
        j = (ck._bitrev(kr, row_log) << col_log) | lane
        rows = torch.cat([2 * j, 2 * j + 1, n - 2 - 2 * j, n - 1 - 2 * j]).reshape(-1)
        assert torch.equal(torch.sort(rows).values, torch.arange(n))
        # a warp's rows: rows_per_warp of the tile's, the 8 warps cover it
        warps = min(8, tile_rows)
        assert warps * rpw == tile_rows


def test_interaction_bound_and_refusals():
    comp = T_CLASSES["processor"](20)
    n = 1 << 20
    nbytes, products, adds = ck.launch_work(comp, "interaction", n)
    per_row = ck.launch_work(comp, "interaction", n, batch=0)[1]
    # 8 live columns in; 3 Q_k and S out; the elements and the claimed sum
    assert nbytes == n * 4 * (8 + 16) + 4 * cg.ELEMENT_WORDS + 16
    # each relation's inverse: 62 products alone, 20 and a share of the batch's
    base, _ = cg.op_work(tfw.constraint_program(type(comp)),
                         tfw.constraint_program(type(comp)).fractions, (0, 18))
    assert per_row == n * (base + 3 * 62)
    assert products == n * (base + 3 * 20) + (n // 4) * (3 * (12 - 1) + 42)
    assert adds == ck.launch_work(comp, "logup", n)[2] + 4 * (n - 1)
    mem = T_CLASSES["memory"](20)
    assert ck.launch_work(mem, "interaction", n)[0] == n * 48 + 4 * cg.ELEMENT_WORDS + 16
    cols, els = _case("memory", 6, 0, False)
    main = {c: convert.to_torch(v) for c, v in cols.items()}
    with pytest.raises(ValueError, match="CUDA"):
        ck.KERNELS.interaction(T_CLASSES["memory"](6), main, _elements(tfw, els))
    with pytest.raises(ValueError, match="rows"):
        ck.KERNELS.interaction(T_CLASSES["memory"](7), main, _elements(tfw, els))
    with pytest.raises(TypeError, match="int32"):
        ck.KERNELS.interaction(T_CLASSES["memory"](6), {**main, "clk": main["clk"].long()},
                               _elements(tfw, els))
    assert ck.KERNELS.lib._lib is None
    assert ck.KERNELS.launches["interaction"] == 0
