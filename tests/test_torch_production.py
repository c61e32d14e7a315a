"""Production parameters (PcsConfig(log_blowup=4, n_queries=30, pow_bits=16),
docs/SECURITY.md) held against the JAX package on the CPU: byte-identical
proofs, each package verifying the other's, for the small program and
fib19_io at a small input. Tolerance: none, bit for bit.

Also the index arithmetic of the two kernels at the largest sizes a
production prove gives them (fib19_io at input 19: the composition
committed at 2^28 leaves, after a fused extend (4, 2^24) -> 2^28): every
offset the Blake2s tree kernel forms for a tree of kMaxLevel = 28 levels
and every row offset of the extend's launches, evaluated in the C types
the kernels use, stays inside its buffer without wrapping."""

import json
import os

import pytest
import torch

from stwo_brainfuck_tpu import air as jair
from stwo_brainfuck_tpu.core.pcs import PcsConfig as JaxPcsConfig
from stwo_brainfuck_tpu.vm.compiler import compile_program as jcompile
from stwo_brainfuck_tpu.vm.machine import create_test_machine as jmachine
from stwo_brainfuck_tpu_torch import air as tair
from stwo_brainfuck_tpu_torch import bench
from stwo_brainfuck_tpu_torch.ops import blake2s_kernels as bk
from stwo_brainfuck_tpu_torch.ops import circle_fft
from stwo_brainfuck_tpu_torch.vm.compiler import compile_program as tcompile
from stwo_brainfuck_tpu_torch.vm.machine import create_test_machine as tmachine

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCTION = bench.CONFIGS["production"]
with open(os.path.join(ROOT, "programs", "fib19_io.bf")) as _f:
    FIB = _f.read()
# fib19_io at input 2: 70 steps, tables up to 2^8 rows (composition 2^12,
# committed at 2^16 leaves at blowup 4)
CASES = {"small": (bench.SMALL_CODE, b"\x01"), "fib19_io_in2": (FIB, b"\x02")}


@pytest.fixture(scope="module")
def proofs():
    cfg = JaxPcsConfig(**PRODUCTION.to_json())
    out = {}
    for name, (code, inp) in CASES.items():
        jm = jmachine(jcompile(code), inp)
        jm.execute()
        tm = tmachine(tcompile(code), inp)
        tm.execute()
        out[name] = (jair.prove_brainfuck(jm, cfg),
                     tair.prove_brainfuck(tm, PRODUCTION, device="cpu"))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_production_proof_is_byte_identical_to_jax(proofs, name):
    jp, tp = proofs[name]
    assert tp["config"] == {"log_blowup": 4, "n_queries": 30, "pow_bits": 16, "log_max_rows": 0}
    for field in ("claim", "commitments", "sampled_values", "fri", "pow_nonce", "decommitments"):
        assert tp[field] == jp[field], f"production proofs diverge at {field}"
    assert json.dumps(tp) == json.dumps(jp)


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_package_verifies_the_others_production_proof(proofs, name):
    jp, tp = proofs[name]
    tair.verify_brainfuck(jp, min_config=PRODUCTION, device="cpu")
    jair.verify_brainfuck(json.loads(json.dumps(tp)))


def test_small_production_matches_recorded_sha256(proofs):
    """chip_smoke.py holds the card's small production proof to this sha256."""
    assert bench.proof_sha256(proofs["small"][0]) == bench.REFERENCE_SHA256["small_production"]


class _C:
    """Integer arithmetic in one C type, raising where the C value would
    wrap: u32 (uint32_t), i32 (int)."""

    def __init__(self, bits: int, signed: bool):
        self.lo = -(1 << (bits - 1)) if signed else 0
        self.hi = (1 << (bits - 1)) - 1 if signed else (1 << bits) - 1

    def __call__(self, value: int, what: str) -> int:
        assert self.lo <= value <= self.hi, f"{what} = {value} wraps"
        return value


U32, I32 = _C(32, False), _C(32, True)


def test_tree_kernel_offsets_at_level_28_do_not_wrap():
    """The tree kernel (csrc/blake2s.cu tree_kernel) on a tree of levels
    28 .. 0 with four columns at level 28 (the production composition tree):
    each expression it forms, for the largest CTA, thread and word, in its
    C type, and the word it reaches inside the buffer of _tree_buffer
    (8 * (2^29 - 1) digest words, then the counters)."""
    k_top = bk.MAX_LEVEL
    assert k_top == 28
    stages, n_counters = bk.tree_stages(k_top, bk.H100_SMS * bk.CTAS_A_SM)
    words = 8 * ((2 << k_top) - 1)
    assert words == 2**32 - 8
    cols, col_stride = 4, 1 << k_top  # the (4, 2^28) extension, rows contiguous
    # the wrapper's own check that a level's columns span at most 2^32 words
    assert col_stride * (cols - 1) + (1 << k_top) <= 1 << 32
    for j, (top, bottom, cta_log, counter) in enumerate(stages):
        last_cta = (1 << cta_log) - 1
        for k in range(top, bottom - 1, -1):
            n_log = k - cta_log
            # i = (cta << n_log) + t, uint32, for the last CTA's last thread
            i = U32(U32(last_cta << n_log, "cta << n_log") + (1 << n_log) - 1, "i")
            assert i < 1 << k
            # level = a.out + 8u * ((1u << k) - 1u); level[(w << k) + i]: w << k is an int
            base = U32(8 * (U32(1 << k, "1u << k") - 1), "level offset")
            word = U32(I32(7 << k, "w << k") + i, "(w << k) + i")
            assert base + word < words
            # the shared tile: dst[(w << n_log) + t] within even[8 * 256]
            assert (7 << n_log) + (1 << n_log) - 1 < 8 * (1 << bk.SUBTREE_LOG)
            if k == top and j > 0:
                # gsrc = a.out + 8u * ((2u << k) - 1u); src + w * stride + 2 * i (+1)
                gbase = U32(8 * (U32(2 << k, "2u << k") - 1), "children offset")
                child = U32(U32(7 * U32(2 << k, "stride"), "w * stride") + 2 * i + 1,
                            "children word")
                assert gbase + child < words
            if k == k_top:
                # cp = lv.cols + i; cp + c0 * col_stride + j * stride (j < R <= 16)
                U32((cols - 1) * col_stride, "j * stride")
                assert i + (cols - 1) * col_stride < cols * col_stride
        if cta_log:
            nxt_log, nxt_counter = stages[j + 1][2], stages[j + 1][3]
            slot = nxt_counter + (last_cta >> (cta_log - nxt_log))
            assert slot < n_counters
    # the levels' views of one buffer on no device: offsets and extents in range
    buf, views = bk._tree_buffer(k_top, n_counters, "meta")
    assert buf.numel() == words + n_counters
    for k, view in views.items():
        assert view.storage_offset() == 8 * ((1 << k) - 1)
        assert view.storage_offset() + 7 * view.stride(0) + view.shape[1] <= words


def test_fused_extend_offsets_at_2_28_do_not_wrap():
    """The fused extend (4, 2^24) -> 2^28 at blowup 4 (csrc/circle_fft.cu
    fft_pass): a block's row ((r0 + i) << rshift) + copy is an int before it
    is widened and shifted by n; a tile's offset in its row (Tile: base +
    ((e >> w) << l0) + (e & (2^w - 1))) is an int below 2^n for the last
    block and element; the grid's y stays within the launch limit."""
    rows, n, blowup = 4, 24, PRODUCTION.log_blowup
    plan = circle_fft.launch_plan("extend", n, rows, blowup)
    assert [launch.mode for launch in plan] == [circle_fft.MODE_INVERSE, circle_fft.MODE_EXTEND,
                                                circle_fft.MODE_FORWARD]
    for launch in plan:
        rshift = launch.copies_log if launch.mode == circle_fft.MODE_FORWARD else 0
        I32(((rows - 1) << rshift) + (1 << rshift) - 1, "((r0 + i) << rshift) + copy")
        s_count, w, l0 = launch.s_count, launch.w_log, launch.l0
        pos = I32((1 << (n - launch.tile_log)) - 1, "blockIdx.x")
        chunk_log = l0 - w
        base = I32(((pos >> chunk_log) << (l0 + s_count))
                   + ((pos & ((1 << chunk_log) - 1)) << w), "base")
        e = (1 << launch.tile_log) - 1
        offset = I32(base + ((e >> w) << l0) + (e & ((1 << w) - 1)), "offset")
        assert offset == (1 << n) - 1
        assert launch.grid()[1] <= circle_fft.MAX_GRID_Y
