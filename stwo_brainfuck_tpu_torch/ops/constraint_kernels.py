"""The constraint kernels: the hand-written Hopper kernels
(``csrc/constraint_kernel.cuh`` with the bodies ``ops/constraint_codegen.py``
emits into ``csrc/constraints.cu``) behind
``framework.component.composition_accumulate`` and ``logup_fractions`` on
CUDA tensors.

Counterparts of ``stwo_brainfuck_tpu/framework/component.py``'s
``_constraints_fn`` (the composition contribution of a component, one fused
executable) and the fraction half of ``_build_interaction_fn`` (the LogUp
fractions and their sum); bit for bit the plain versions
``composition_contribution`` and ``logup_fractions_plain`` (the Expr path).

``KERNELS.composition(...)``: acc (4, m) int32 (+)= the component's weighted
constraint sum over V_n at storage positions offset .. offset + m - 1 of its
blown-up domain, in one launch; V_n^-1 takes 2^log_blowup values there
(``core/poly.py`` ``vanishing_inverse_blocks``), which ride in the launch's
constant table, and S(p - g) is read through the int32 rotation index
(``core/fft.py`` ``rotation_index``) or from rows the kernel is given.
``KERNELS.logup(...)``: ((K, 4, n) int32 Q_k, (4, n) int32 their sum) in
one launch.

Each launch's column pointers and constants (the lookup elements, the
claimed sum, the weights alpha^(offset + i), V_n^-1) go to the card as one
small table from pinned memory with one non-blocking copy. The wrapper checks
what it is given (CUDA, int32, 1-D rows with unit stride, one length, one
device, the positions inside the domain) before it loads the library, and
raises on what the kernel does not take; the C entry returns
``cudaGetLastError()`` and the wrapper raises if it is not 0. The library
is built with nvcc at first use (``ops/nvcc.py``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..components.defs import COMPONENT_CLASSES
from ..core import poly, qm31
from ..core.m31 import P_INT
from ..framework.component import LookupElements, constraint_program, emulate
from . import nvcc
from .constraint_codegen import (CLAIMED_WORD, ELEMENT_ORDER, ELEMENT_WORDS, WEIGHTS_WORD,
                                 composition_slots, logup_slots, op_work)

FAMILIES = ("composition", "logup")
MAX_EVAL_LOG = 30  # qm31::kMaxLogSize: the largest canonic domain the kernel takes
COMPONENT_IDS = {cls.name: i for i, cls in enumerate(COMPONENT_CLASSES)}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.constraints_components.restype = i32
    lib.constraints_component_name.argtypes = [i32]
    lib.constraints_component_name.restype = ctypes.c_char_p
    lib.constraints_shape.argtypes = [i32, ptr]
    lib.constraints_shape.restype = i32
    lib.constraints_composition.argtypes = [i32, ptr, i32, i32, ptr, i32, i32, i64, i64, ptr,
                                            i32, ptr]
    lib.constraints_composition.restype = i32
    lib.constraints_logup.argtypes = [i32, ptr, i32, i32, i64, ptr, ptr, ptr]
    lib.constraints_logup.restype = i32
    # the built file must be the one the programs emit now
    if lib.constraints_components() != len(COMPONENT_CLASSES):
        raise RuntimeError("csrc/constraints.cu: another component count; regenerate it")
    for cls, i in ((c, COMPONENT_IDS[c.name]) for c in COMPONENT_CLASSES):
        shape = (ctypes.c_int * 5)()
        lib.constraints_shape(i, ctypes.addressof(shape))
        if lib.constraints_component_name(i).decode() != cls.name or tuple(shape) != shape_of(cls):
            raise RuntimeError(f"csrc/constraints.cu: component {i} is not {cls.name} "
                               f"{shape_of(cls)}; regenerate it")


def shape_of(cls) -> Tuple[int, int, int, int, int]:
    """(columns, relations, constraints, composition pointer slots,
    composition constant words before V_n^-1's) of a component class."""
    p = constraint_program(cls)
    return (len(p.columns), len(p.relations), len(p.constraints), composition_slots(p),
            WEIGHTS_WORD + 4 * len(p.constraints))


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

def _words(v) -> list:
    return [int(c) % P_INT for c in v]


def pack_constants(elements: Dict[str, LookupElements], claimed_sum=None,
                   weights: Sequence[tuple] = (), v_inv: Sequence[int] = ()) -> np.ndarray:
    """The constant words of a launch (uint32): the lookup elements in
    ELEMENT_ORDER (alpha^0 .. alpha^(size - 1), z), then for composition
    the claimed sum, the weights and V_n^-1's values."""
    words = []
    for name in ELEMENT_ORDER:
        els = elements[name]
        for a in els.alpha_powers:
            words += _words(a)
        words += _words(els.z)
    assert len(words) == ELEMENT_WORDS
    if claimed_sum is not None:
        words += _words(claimed_sum)
        assert len(words) == WEIGHTS_WORD
        for w in weights:
            words += _words(w)
        words += _words(v_inv)
    return np.array(words, np.uint32)


def weights(alpha: tuple, alpha_offset: int, n: int) -> list:
    """alpha^(alpha_offset + i), i < n (host QM31)."""
    first = qm31.h_pow(alpha, alpha_offset)
    out = [first]
    for _ in range(n - 1):
        out.append(qm31.h_mul(out[-1], alpha))
    return out


def pack_table(pointers: Sequence[int], words: np.ndarray) -> np.ndarray:
    """A launch's table as uint32 words: the pointers (8 bytes each, little
    endian), then the constant words."""
    return np.concatenate([np.array(pointers, np.uint64).view(np.uint32), words])


def _to_card(table: np.ndarray, dev) -> torch.Tensor:
    """The table on `dev`: one non-blocking copy from pinned memory."""
    return torch.from_numpy(table.view(np.int32)).pin_memory().to(dev, non_blocking=True)


def emulate_composition(component, main_cols: Dict[str, torch.Tensor],
                        inter_rows: Sequence[torch.Tensor], s_rows: Sequence[torch.Tensor],
                        rotation: Optional[torch.Tensor], is_first: torch.Tensor,
                        claimed_sum: tuple, elements: Dict[str, LookupElements], alpha: tuple,
                        alpha_offset: int, log_blowup: int, acc: Optional[torch.Tensor],
                        offset: int = 0) -> Tuple[torch.Tensor, int]:
    """What one composition launch computes, on any device: the program's
    ops (framework.component.emulate), the weights and V_n^-1's values of
    the constant table (V_n^-1 read at position >> log_size) and the
    accumulation;
    ((4, m) int32, next alpha offset). acc is not changed."""
    program = constraint_program(type(component))
    m = is_first.shape[0]
    dev = is_first.device
    s_prev = torch.stack(list(s_rows))
    if rotation is not None:
        s_prev = s_prev[:, rotation[offset:offset + m].to(torch.int64)]
    vals = emulate(program, {
        "cols": [main_cols[c] for c in component.columns], "is_first": is_first,
        "inter": [list(inter_rows[4 * k:4 * k + 4]) for k in range(len(inter_rows) // 4)],
        "s_prev": s_prev, "claimed": claimed_sum, "elements": elements}, program.constraints)
    total = torch.zeros((4, m), dtype=torch.int64, device=dev)
    for w, c in zip(weights(alpha, alpha_offset, len(program.constraints)), program.constraints):
        wq = qm31.const(w, dev)
        total = (total + (qm31.mul(wq, vals[c]) if program.qm[c] else wq * vals[c] % P_INT)) % P_INT
    pos = torch.arange(offset, offset + m, dtype=torch.int64, device=dev)
    v_inv = torch.tensor(poly.vanishing_inverse_blocks(component.log_size, log_blowup),
                         dtype=torch.int64, device=dev)
    total = total * v_inv[pos >> component.log_size] % P_INT
    if acc is not None:
        total = (total + acc.to(torch.int64)) % P_INT
    return total.to(torch.int32), alpha_offset + len(program.constraints)


def emulate_logup(component, main_cols: Dict[str, torch.Tensor], is_first: torch.Tensor,
                  elements: Dict[str, LookupElements]) -> Tuple[torch.Tensor, torch.Tensor]:
    """What one logup launch computes, on any device: ((K, 4, n) int32 Q_k,
    (4, n) int32 their sum)."""
    program = constraint_program(type(component))
    vals = emulate(program, {"cols": [main_cols[c] for c in component.columns],
                             "is_first": is_first, "elements": elements}, program.fractions)
    q = torch.stack([vals[f] for f in program.fractions])
    return q.to(torch.int32), (q.sum(0) % P_INT).to(torch.int32)


# ---------------------------------------------------------------------------
# Checks (before any library load)
# ---------------------------------------------------------------------------

def _check_rows(rows: Sequence[torch.Tensor], what: str, n: Optional[int] = None
                ) -> Tuple[torch.device, int]:
    """Raise unless the rows are int32 vectors of one length (n if given)
    with unit stride on one device; returns the device and the length."""
    if not rows:
        raise ValueError(f"{what}: no rows")
    for r in rows:
        if not isinstance(r, torch.Tensor):
            raise TypeError(f"{what}: a row is a {type(r).__name__}, not a tensor")
        if r.dtype != torch.int32:
            raise TypeError(f"the constraint kernels take int32 rows, {what} has {r.dtype}")
    n = int(rows[0].shape[-1]) if n is None else n
    for r in rows:
        if r.dim() != 1 or r.shape[0] != n:
            raise ValueError(f"{what}: a row of shape {tuple(r.shape)}, expected ({n},)")
        if n > 1 and r.stride(0) != 1:
            raise ValueError(f"{what}: row stride {r.stride(0)}, the kernel takes 1")
        if r.device != rows[0].device:
            raise ValueError(f"{what}: rows on {r.device} and {rows[0].device}")
    if not n:
        raise ValueError(f"{what}: empty rows")
    return rows[0].device, n


def _require_cuda(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"the constraint kernels take CUDA tensors, {what} is on {dev}")


def _main_rows(component, main_cols: Dict[str, torch.Tensor]) -> list:
    missing = [c for c in component.columns if c not in main_cols]
    if missing:
        raise ValueError(f"{component.name}: no column {missing}")
    return [main_cols[c] for c in component.columns]


class ConstraintKernels:
    """The built library and the launch count of each family."""

    def __init__(self):
        self.lib = nvcc.CudaLibrary("constraints", _bind)
        self.launches = dict.fromkeys(FAMILIES, 0)

    def composition(self, component, main_cols: Dict[str, torch.Tensor],
                    inter_rows: Sequence[torch.Tensor], s_rows: Sequence[torch.Tensor],
                    rotation: Optional[torch.Tensor], is_first: torch.Tensor,
                    claimed_sum: tuple, elements: Dict[str, LookupElements], alpha: tuple,
                    alpha_offset: int, log_blowup: int, acc: Optional[torch.Tensor],
                    offset: int = 0) -> Tuple[torch.Tensor, int]:
        """framework.component.composition_accumulate in one launch: (acc,
        next alpha offset)."""
        cls = type(component)
        program = constraint_program(cls)
        n_inter = len(program.relations) + 1
        if len(inter_rows) != 4 * n_inter or len(s_rows) != 4:
            raise ValueError(f"{component.name}: {len(inter_rows)} interaction rows and "
                             f"{len(s_rows)} S rows, expected {4 * n_inter} and 4")
        rows = _main_rows(component, main_cols) + [is_first, *inter_rows]
        dev, m = _check_rows(rows, f"{component.name} composition")
        eval_log = component.log_size + log_blowup
        if (component.log_size < 1 or log_blowup < 0 or eval_log > MAX_EVAL_LOG or offset < 0
                or offset + m > 1 << eval_log):
            raise ValueError(f"{component.name} composition: positions {offset} .. "
                             f"{offset + m - 1} of a domain of 2^{eval_log}")
        if rotation is None:
            _check_rows([is_first, *s_rows], f"{component.name} S(p - g) rows", m)
        else:
            _check_rows([*s_rows, rotation], f"{component.name} S rows and rotation index",
                        1 << eval_log)
            if rotation.device != dev:
                raise ValueError(f"{component.name} composition: S rows on {rotation.device}, "
                                 f"the columns on {dev}")
        if acc is not None:
            if (acc.dtype != torch.int32 or acc.shape != (4, m) or not acc.is_contiguous()
                    or acc.device != dev):
                raise ValueError(f"{component.name} composition: acc {acc.dtype} "
                                 f"{tuple(acc.shape)} on {acc.device}, expected contiguous "
                                 f"int32 (4, {m}) on {dev}")
        _require_cuda(dev, f"{component.name} composition")
        lib = self.lib.load()
        words = pack_constants(elements, claimed_sum,
                               weights(alpha, alpha_offset, len(program.constraints)),
                               poly.vanishing_inverse_blocks(component.log_size, log_blowup))
        host = pack_table([r.data_ptr() for r in rows + list(s_rows)], words)
        out = acc if acc is not None else torch.empty((4, m), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            table = _to_card(host, dev)
            rc = lib.constraints_composition(
                COMPONENT_IDS[component.name], table.data_ptr(), len(rows) + 4, words.size,
                None if rotation is None else rotation.data_ptr(), component.log_size, log_blowup,
                offset, m, out.data_ptr(), int(acc is not None),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{component.name} composition kernel launch failed: "
                               f"CUDA error {rc}")
        self.launches["composition"] += 1
        return out, alpha_offset + len(program.constraints)

    def logup(self, component, main_cols: Dict[str, torch.Tensor], is_first: torch.Tensor,
              elements: Dict[str, LookupElements]) -> Tuple[torch.Tensor, torch.Tensor]:
        """framework.component.logup_fractions in one launch: ((K, 4, n)
        int32 Q_k, (4, n) int32 their sum)."""
        program = constraint_program(type(component))
        rows = _main_rows(component, main_cols) + [is_first]
        dev, n = _check_rows(rows, f"{component.name} logup")
        _require_cuda(dev, f"{component.name} logup")
        lib = self.lib.load()
        words = pack_constants(elements)
        host = pack_table([r.data_ptr() for r in rows], words)
        q = torch.empty((len(program.relations), 4, n), dtype=torch.int32, device=dev)
        total = torch.empty((4, n), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            table = _to_card(host, dev)
            rc = lib.constraints_logup(COMPONENT_IDS[component.name], table.data_ptr(),
                                       logup_slots(program), words.size, n, q.data_ptr(),
                                       total.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{component.name} logup kernel launch failed: CUDA error {rc}")
        self.launches["logup"] += 1
        return q, total


KERNELS = ConstraintKernels()


# ---------------------------------------------------------------------------
# The kernels' work, for their bounds
# ---------------------------------------------------------------------------

def launch_work(component, family: str, rows: int, accumulate: bool = True,
                rotation: bool = True, log_blowup: int = 0) -> Tuple[int, int, int]:
    """(bytes, M31 products, M31 adds) of one launch over `rows` rows, the
    work the function needs: each input word read once and each output
    word written once; the program's distinct ops
    (ops/constraint_codegen.op_work) and, for composition, the weights, the
    product by V_n^-1 and the accumulation at every row, and once a launch
    the 2^log_blowup values of V_n^-1 (a point, log_size - 1 doublings and
    an inversion each: core/poly.py vanishing_inverse_blocks)."""
    p = constraint_program(type(component))
    if family == "logup":
        products, adds = op_work(p, p.fractions)
        live = p.live(p.fractions)
        inputs = sum(1 for v in live if p.ops[v][0] in ("col", "is_first"))
        return (rows * 4 * (inputs + 4 * (len(p.relations) + 1)) + 4 * ELEMENT_WORDS,
                rows * products, rows * (adds + 4 * (len(p.relations) - 1)))
    products, adds = op_work(p, p.constraints)
    live = p.live(p.constraints)
    words = sum(4 if p.ops[v][0] in ("inter", "s_prev") else 1
                for v in live if p.ops[v][0] in ("col", "is_first", "inter", "s_prev"))
    if rotation and ("inter", len(p.relations)) in (p.ops[v] for v in live):
        words -= 4  # S(p - g) is S's rows read again at the rotation: one input
    words += int(rotation) + 4 * (1 + int(accumulate))
    for c in p.constraints:
        products += 16 if p.qm[c] else 4
    adds += 4 * (len(p.constraints) - 1)
    products += 4  # the product by V_n^-1
    adds += 4 * int(accumulate)
    n, blocks = component.log_size, 1 << log_blowup
    table = WEIGHTS_WORD + 4 * len(p.constraints) + blocks
    return (rows * 4 * words + 4 * table, rows * products + blocks * (4 + (n - 1) + 42),
            rows * adds + blocks * (3 + 2 * (n - 1)))
