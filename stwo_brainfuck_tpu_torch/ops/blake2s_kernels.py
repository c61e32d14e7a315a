"""Blake2s hashing kernels: the hand-written Hopper kernels
(``csrc/blake2s.cu``) behind the Merkle levels, the small top of a tree and
the proof-of-work grind.

Counterpart of how the JAX package runs ``stwo_brainfuck_tpu/core/
blake2s.py``'s ``_compress_t``: one fused device program per Merkle level
(``core/merkle.py`` ``_leaf_hash_jit`` / ``_node_hash_jit`` /
``_chain_hash_jit`` on the schedule of ``level_plan``) and per PoW batch
(``core/channel.py`` ``_pow_batch``). Digests are bit-identical to the
plain torch version, ``core/blake2s.hash_parts``.

- ``KERNELS.level(children, columns)``: one level's (8, m) int32 digests,
  node i = H(child 2i || child 2i+1 || columns[:, i]);
- ``KERNELS.tail(children, k_top, k_bottom)``: a run of digest-only levels
  with at most 2^TAIL_LOG nodes in one launch, each level a (8, 2^k) view
  of one buffer;
- ``KERNELS.grind(digest, pow_bits)``: the smallest nonce whose hash has
  pow_bits low zero bits, scanned GRIND_BATCH nonces a launch.

``level_plain`` and ``tail_plain`` are the kernels' plain versions (the
plain ``hash_parts``; the tail's levels as views of one buffer, laid out as
the kernel writes them). ``launch_plan`` is the schedule of one tree
(levels and tails), and ``walk_plan`` runs it with given level and tail
functions: the kernels on CUDA tensors (``core/merkle.commit``), or the
plain versions (``emulate_commit``, on any device), so the CPU tests check
the plan.

Every wrapper checks what it is given (CUDA, int32, last stride 1, shapes)
before it loads the library, and raises on what the kernel does not take.
The library is built with nvcc at first use (``ops/nvcc.py``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import blake2s
from . import nvcc

ENTRIES = ("level", "tail", "grind")
# The tail's first level has at most 2^TAIL_LOG nodes (kTailLog in
# csrc/blake2s.cu, checked when the library loads).
TAIL_LOG = 10
GRIND_BATCH_LOG = 20
_NO_HIT = 0xFFFFFFFF


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, i32, u64, u32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_ulonglong, ctypes.c_uint)
    lib.blake2s_level.argtypes = [ptr, i64, ptr, i64, i32, i64, i64, ptr, ptr]
    lib.blake2s_tail.argtypes = [ptr, i64, i32, i32, ptr, ptr]
    lib.blake2s_grind.argtypes = [ptr, u64, u32, u32, ptr, ptr]
    for fn in (lib.blake2s_level, lib.blake2s_tail, lib.blake2s_grind, lib.blake2s_tail_log):
        fn.restype = ctypes.c_int
    if lib.blake2s_tail_log() != TAIL_LOG:
        raise RuntimeError(f"csrc/blake2s.cu has kTailLog {lib.blake2s_tail_log()}, "
                           f"the wrapper {TAIL_LOG}")


def _check(x: torch.Tensor, what: str, rows: Optional[int] = None,
           cols: Optional[int] = None) -> None:
    """Raise unless x is a CUDA int32 matrix with unit last stride (and the
    given shape)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"Blake2s {what}: expected a tensor, got {type(x).__name__}")
    if x.dtype != torch.int32:
        raise TypeError(f"the Blake2s kernels take int32 words, {what} is {x.dtype}")
    if x.dim() != 2 or (rows is not None and x.shape[0] != rows) or (
            cols is not None and x.shape[1] != cols):
        want = (rows if rows is not None else "W", cols if cols is not None else "N")
        raise ValueError(f"Blake2s {what}: shape {tuple(x.shape)}, expected {want}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"Blake2s {what}: last stride {x.stride(1)}, the kernels take 1")
    if not x.is_cuda:
        raise ValueError(f"the Blake2s kernels take CUDA tensors, {what} is on {x.device}")


def _rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"Blake2s {what} launch failed: CUDA error {rc}")


class Blake2sKernels:
    """The built kernel library and one launch count per entry point."""

    def __init__(self):
        self.lib = nvcc.CudaLibrary("blake2s", _bind)
        self.launches = dict.fromkeys(ENTRIES, 0)

    def level(self, children: Optional[torch.Tensor], columns: Optional[torch.Tensor],
              n_bytes: Optional[int] = None) -> torch.Tensor:
        """(8, m) int32 digests of one level: node i hashes children[:, 2i]
        || children[:, 2i+1] || columns[:, i] (children (8, 2m) or None,
        columns (C, m) or None; n_bytes overrides the true length 4 * words)."""
        if children is None and columns is None:
            raise ValueError("Blake2s level: no children and no columns")
        if children is not None:
            _check(children, "children", rows=8)
            m = children.shape[1] // 2
            if children.shape[1] != 2 * m or m == 0:
                raise ValueError(f"Blake2s level: {children.shape[1]} children is not 2m > 0")
        if columns is not None:
            _check(columns, "columns", cols=None if children is None else m)
            m = columns.shape[1]
            if children is not None and columns.device != children.device:
                raise ValueError("Blake2s level: children and columns on different devices")
        if m == 0:
            raise ValueError("Blake2s level: no nodes")
        dev = (children if children is not None else columns).device
        n_words = (16 if children is not None else 0) + (0 if columns is None else columns.shape[0])
        if n_bytes is not None and not 0 <= n_bytes <= 4 * n_words:
            raise ValueError(f"Blake2s level: n_bytes {n_bytes} for {n_words} words")
        lib = self.lib.load()
        out = torch.empty((8, m), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.blake2s_level(
                None if children is None else children.data_ptr(),
                0 if children is None else children.stride(0),
                None if columns is None else columns.data_ptr(),
                0 if columns is None else columns.stride(0),
                0 if columns is None else columns.shape[0], m,
                -1 if n_bytes is None else n_bytes, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _rc(rc, "level")
        self.launches["level"] += 1
        return out

    def tail(self, children: torch.Tensor, k_top: int, k_bottom: int) -> Dict[int, torch.Tensor]:
        """Levels k_top .. k_bottom (digest-only, 2^k_top <= 2^TAIL_LOG) from
        the (8, 2^(k_top+1)) digests below them, in one launch: level k ->
        (8, 2^k) int32, views of one buffer."""
        if not 0 <= k_bottom <= k_top <= TAIL_LOG:
            raise ValueError(f"Blake2s tail: levels {k_top} .. {k_bottom} outside "
                             f"{TAIL_LOG} .. 0")
        _check(children, "children", rows=8, cols=2 << k_top)
        lib = self.lib.load()
        buf, views = _tail_buffer(k_top, k_bottom, children.device)
        with torch.cuda.device(children.device):
            rc = lib.blake2s_tail(children.data_ptr(), children.stride(0), k_top, k_bottom,
                                  buf.data_ptr(),
                                  torch.cuda.current_stream(children.device).cuda_stream)
        _rc(rc, "tail")
        self.launches["tail"] += 1
        return views

    def grind(self, digest: bytes, pow_bits: int, device) -> int:
        """The smallest nonce whose Blake2s(digest || nonce_le8) has pow_bits
        low zero bits in its first word: 2^GRIND_BATCH_LOG nonces a launch,
        each launch's smallest hit kept with atomicMin; 4 bytes come back a
        batch."""
        if len(digest) != 32 or not 0 <= pow_bits <= 32:
            raise ValueError(f"Blake2s grind: a 32-byte digest and 0..32 bits, got "
                             f"{len(digest)} bytes and {pow_bits} bits")
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"the Blake2s grind kernel runs on a CUDA device, got {dev}")
        lib = self.lib.load()
        words = torch.as_tensor(np.frombuffer(digest, dtype="<u4").view(np.int32).copy(),
                                device=dev)
        best = torch.empty(1, dtype=torch.int32, device=dev)
        batch = 1 << GRIND_BATCH_LOG
        mask = (1 << pow_bits) - 1
        base = 0
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            while base < 1 << 48:  # unreachable for sane pow_bits
                best.fill_(-1)
                rc = lib.blake2s_grind(words.data_ptr(), base, batch, mask, best.data_ptr(),
                                       stream)
                _rc(rc, "grind")
                self.launches["grind"] += 1
                hit = int(best.item()) & 0xFFFFFFFF
                if hit != _NO_HIT:
                    return base + hit
                base += batch
        raise RuntimeError("PoW grind exhausted")


KERNELS = Blake2sKernels()


def _tail_buffer(k_top: int, k_bottom: int, device) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """One int32 buffer for levels k_top .. k_bottom and its (8, 2^k) views:
    level k at word offset 8 * (2^k - 2^k_bottom), as the kernel writes it."""
    lo = 1 << k_bottom
    buf = torch.empty(8 * ((2 << k_top) - lo), dtype=torch.int32, device=device)
    views = {k: buf[8 * ((1 << k) - lo): 8 * ((2 << k) - lo)].view(8, 1 << k)
             for k in range(k_top, k_bottom - 1, -1)}
    return buf, views


# ---------------------------------------------------------------------------
# The schedule of one tree
# ---------------------------------------------------------------------------

def launch_plan(sig: Sequence[Tuple[int, int]], max_log: Optional[int] = None) -> List[tuple]:
    """The launches that hash levels max_log .. 0 of a tree whose columns
    sit at the levels of `sig` [(level, n_cols), ...] (max_log: the deepest
    level hashed, max(sig) by default; deeper digests may feed it):
    ("level", k, C) for a level with C columns, or a digest-only level with
    more than 2^TAIL_LOG nodes (C = 0); ("tail", k_top, k_bottom) for each
    run of digest-only levels below that. Every level appears once, deepest
    first."""
    by = dict(sig)
    if max_log is None:
        if not by:
            raise ValueError("launch_plan: a tree without columns needs max_log")
        max_log = max(by)
    if any(k > max_log or k < 0 for k in by):
        raise ValueError(f"launch_plan: column levels {sorted(by)} outside {max_log} .. 0")
    steps: List[tuple] = []
    k = max_log
    while k >= 0:
        if k in by or k > TAIL_LOG:
            steps.append(("level", k, by.get(k, 0)))
            k -= 1
            continue
        bottom = k
        while bottom - 1 >= 0 and bottom - 1 not in by:
            bottom -= 1
        steps.append(("tail", k, bottom))
        k = bottom - 1
    return steps


LevelFn = Callable[[Optional[torch.Tensor], Optional[torch.Tensor]], torch.Tensor]
TailFn = Callable[[torch.Tensor, int, int], Dict[int, torch.Tensor]]


def walk_plan(plan: List[tuple], columns_by_log: Dict[int, torch.Tensor],
              prev: Optional[torch.Tensor], level: LevelFn, tail: TailFn) -> Dict[int, torch.Tensor]:
    """Run `plan` from the digests `prev` below its first level (None at a
    tree's deepest level): level k -> (8, 2^k) digests."""
    layers: Dict[int, torch.Tensor] = {}
    for step in plan:
        if step[0] == "level":
            prev = level(prev, columns_by_log.get(step[1]))
            layers[step[1]] = prev
        else:
            if prev is None:
                raise ValueError(f"a tail at level {step[1]} has no digests below it")
            layers.update(tail(prev, step[1], step[2]))
            prev = layers[step[2]]
    return layers


# ---------------------------------------------------------------------------
# Plain versions (hash_parts, the kernels' layout) and the plan replayed
# ---------------------------------------------------------------------------

def level_plain(children: Optional[torch.Tensor], columns: Optional[torch.Tensor],
                n_bytes: Optional[int] = None) -> torch.Tensor:
    """What the level kernel computes (core/merkle.hash_level on the CPU):
    each node's message read word by word as the kernel reads it
    (children[w][2i], children[w][2i+1], then columns[c][i]), hashed with
    the plain hash_parts."""
    parts = []
    if children is not None:
        parts += [children[:, 0::2], children[:, 1::2]]
    if columns is not None:
        parts.append(columns)
    return blake2s.words_to_int32(blake2s.hash_parts(parts, n_bytes))


def tail_plain(children: torch.Tensor, k_top: int, k_bottom: int) -> Dict[int, torch.Tensor]:
    """What the tail kernel computes: levels k_top .. k_bottom, each hashed
    from the one below and written to its slice of one buffer."""
    if not 0 <= k_bottom <= k_top <= TAIL_LOG:
        raise ValueError(f"tail levels {k_top} .. {k_bottom} outside {TAIL_LOG} .. 0")
    buf, views = _tail_buffer(k_top, k_bottom, children.device)
    prev = children
    for k in range(k_top, k_bottom - 1, -1):
        views[k].copy_(level_plain(prev, None))
        prev = views[k]
    return views


def emulate_commit(columns_by_log: Dict[int, torch.Tensor]) -> Tuple[bytes, Dict[int, torch.Tensor]]:
    """The root and layers of merkle.commit as the kernels compute them:
    launch_plan's steps replayed with level_plain / tail_plain (on the
    columns' device)."""
    plan = launch_plan([(k, m.shape[0]) for k, m in columns_by_log.items()])
    layers = walk_plan(plan, columns_by_log, None, level_plain, tail_plain)
    return blake2s.digest_to_bytes(layers[0][:, 0]), layers
