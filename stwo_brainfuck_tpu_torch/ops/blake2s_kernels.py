"""Blake2s hashing kernels: the hand-written Hopper kernels
(``csrc/blake2s.cu``) behind the Merkle trees, one level of messages and
the proof-of-work grind.

Counterpart of how the JAX package runs ``stwo_brainfuck_tpu/core/
blake2s.py``'s ``_compress_t``: one fused device program per Merkle level
(``core/merkle.py`` ``_leaf_hash_jit`` / ``_node_hash_jit`` /
``_chain_hash_jit`` on the schedule of ``level_plan``) and per PoW batch
(``core/channel.py`` ``_pow_batch``). Digests are bit-identical to the
plain torch version, ``core/blake2s.hash_parts``.

- ``KERNELS.tree(children, columns_by_log, k_top)``: levels k_top .. 0 of
  a tree in one launch, level k a (8, 2^k) int32 view of one buffer (word
  offset 8 * (2^k - 1)); columns at any level of the run, a row slice
  keeping its stride; ``children`` the digests below k_top or None;
- ``KERNELS.level(children, columns, n_bytes)``: one level's (8, m) int32
  digests, node i = H(child 2i || child 2i+1 || columns[:, i]), with a
  byte-length override (``blake2s.hash_words`` on CUDA);
- ``KERNELS.grind(digest, pow_bits)``: the smallest nonce whose hash has
  pow_bits low zero bits, in one launch of persistent CTAs that walk
  ascending tiles of nonces and stop once a smaller hit is known
  (``grind_order`` and ``emulate_grind`` replay it);
- ``KERNELS.chain(n, chain, device)``: a timing probe off every path
  (``chain`` dependent compressions on each of n threads; not counted).

The tree kernel runs the stages of ``tree_stages``: a CTA of 2^SUBTREE_LOG
threads hashes 2^SUBTREE_LOG nodes of its stage's first level and carries
them up in shared memory to one node; the last CTA to arrive at its
group's counter goes on as a CTA of the next stage, and the one CTA of
the last stage writes the root. ``tree_plain`` is its plain version (level
by level with ``level_plain``, written into the kernel's buffer layout)
and ``emulate_tree`` replays its CTAs, shared levels, counters and writes
with the plain hash on any device, so the CPU tests check the stage
table, the column table and the layout. ``launch_plan`` gives one launch a
tree and ``walk_plan`` runs it with the kernel (``core/merkle`` on CUDA
tensors) or a plain version (``emulate_commit``, and ``core/merkle`` on the
CPU).

Every wrapper checks what it is given (CUDA, int32, last stride 1, shapes,
alignment) before it loads the library, and raises on what the kernel does
not take. The library is built with nvcc at first use (``ops/nvcc.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import tracing
from ..core import blake2s
from . import nvcc

ENTRIES = ("tree", "level", "grind")
# a tree CTA owns 2^SUBTREE_LOG nodes of its stage's first level
# (kSubtreeLog in csrc/blake2s.cu, checked when the library loads)
SUBTREE_LOG = 8
# in a tree whose first stage has more CTAs than the card holds at once, a
# CTA of a stage before the last stops at 2^KEEP_LOG nodes (a full warp), so
# that narrow levels do not idle SMs that have CTAs waiting; in a smaller
# tree it carries its nodes up to one (fewer stages: a shorter root chain)
KEEP_LOG = 5
CTAS_A_SM = 4  # tree_kernel's __launch_bounds__(256, 4)
H100_SMS = 132
MAX_LEVEL = 28  # kMaxLevel: a tree's level offsets stay in 32 bits
MAX_STAGES = 12  # kMaxStages
# the grind: one launch covers GRIND_SPAN nonces (0xFFFFFFFF is "no hit")
# in tiles of GRIND_TILE, GRIND_CTAS_A_SM persistent CTAs an SM
GRIND_SPAN = 0xFFFFFFFF
GRIND_TILE = 256
GRIND_CTAS_A_SM = 4
_NO_HIT = 0xFFFFFFFF

Stage = Tuple[int, int, int, int]  # (top, bottom, cta_log, counter)


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, i32, u64, u32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_ulonglong, ctypes.c_uint)
    lib.blake2s_tree.argtypes = [ptr, i64, i32, ptr, ptr, ptr, ptr, i32, ptr, ptr, i32, ptr]
    lib.blake2s_level.argtypes = [ptr, i64, ptr, i64, i32, i64, i64, ptr, ptr]
    lib.blake2s_grind.argtypes = [ptr, u64, u32, u32, i32, ptr, ptr]
    lib.blake2s_chain.argtypes = [ptr, u32, i32, ptr]
    for fn in (lib.blake2s_tree, lib.blake2s_level, lib.blake2s_grind, lib.blake2s_chain,
               lib.blake2s_subtree_log):
        fn.restype = ctypes.c_int
    if lib.blake2s_subtree_log() != SUBTREE_LOG:
        raise RuntimeError(f"csrc/blake2s.cu has kSubtreeLog {lib.blake2s_subtree_log()}, "
                           f"the wrapper {SUBTREE_LOG}")


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


# ---------------------------------------------------------------------------
# A tree's stages and buffer
# ---------------------------------------------------------------------------

def tree_stages(k_top: int, wave: int, subtree_log: int = SUBTREE_LOG,
                keep_log: int = KEEP_LOG) -> Tuple[Tuple[Stage, ...], int]:
    """The tree kernel's stages for levels k_top .. 0 on a card that holds
    `wave` tree CTAs at once, and the length of their counter area. Stage
    (top, bottom, cta_log, counter): 2^cta_log CTAs, each hashing 2^(k -
    cta_log) nodes of levels top .. bottom, 2^subtree_log at the top
    (children from device memory), carried up in shared memory to
    2^keep_log nodes if the first stage has more CTAs than `wave`, else to
    one; the last stage has one CTA and ends at the root. A stage after the
    first starts one level below the stage before: the last of the
    2^(cta_log' - cta_log) CTAs there to arrive at counter `counter + c`
    goes on as its CTA c."""
    if not 0 <= k_top <= MAX_LEVEL:
        raise ValueError(f"a Blake2s tree of levels {k_top} .. 0: outside {MAX_LEVEL} .. 0")
    if not 0 <= keep_log < subtree_log:
        raise ValueError(f"tree stages: keep 2^{keep_log} of 2^{subtree_log} nodes")
    keep = keep_log if 1 << max(k_top - subtree_log, 0) > wave else 0
    stages: List[Stage] = []
    top, counters = k_top, 0
    while True:
        cta_log = max(top - subtree_log, 0)
        bottom = cta_log + keep if cta_log else 0
        stages.append((top, bottom, cta_log, counters if stages else 0))
        if len(stages) > 1:
            counters += 1 << cta_log
        if cta_log == 0:
            return tuple(stages), counters
        top = bottom - 1


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _wave(device: torch.device) -> int:
    """The tree CTAs the card holds at once."""
    return _sms(device) * CTAS_A_SM


def _tree_buffer(k_top: int, n_counters: int, device) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """One int32 buffer for levels k_top .. 0 (level k at word offset
    8 * (2^k - 1), as the kernel writes it) and the counters behind them;
    returns it and the levels' (8, 2^k) views."""
    words = 8 * ((2 << k_top) - 1)
    buf = torch.empty(words + n_counters, dtype=torch.int32, device=device)
    views = {k: buf.as_strided((8, 1 << k), (1 << k, 1), 8 * ((1 << k) - 1))
             for k in range(k_top, -1, -1)}
    return buf, views


def _check_tree(children: Optional[torch.Tensor], columns_by_log: Dict[int, torch.Tensor],
                k_top: int) -> None:
    """The shapes a tree of levels k_top .. 0 takes, on any device."""
    if not 0 <= k_top <= MAX_LEVEL:
        raise ValueError(f"Blake2s tree: levels {k_top} .. 0 outside {MAX_LEVEL} .. 0")
    if any(not 0 <= k <= k_top for k in columns_by_log):
        raise ValueError(f"Blake2s tree: column levels {sorted(columns_by_log)} outside "
                         f"{k_top} .. 0")
    for k, mat in columns_by_log.items():
        if mat.dim() != 2 or mat.shape[1] != 1 << k or mat.shape[0] == 0:
            raise ValueError(f"Blake2s tree: level {k} columns of shape {tuple(mat.shape)}")
    if children is None and k_top not in columns_by_log:
        raise ValueError(f"Blake2s tree: level {k_top} has no children and no columns")
    if children is not None and tuple(children.shape) != (8, 2 << k_top):
        raise ValueError(f"Blake2s tree: children of shape {tuple(children.shape)} below "
                         f"level {k_top}")


class Blake2sKernels:
    """The built kernel library and one launch count per entry point."""

    def __init__(self):
        self.lib = nvcc.CudaLibrary("blake2s", _bind)
        self.launches = dict.fromkeys(ENTRIES, 0)

    def tree(self, children: Optional[torch.Tensor], columns_by_log: Dict[int, torch.Tensor],
             k_top: int) -> Dict[int, torch.Tensor]:
        """Levels k_top .. 0 in one launch: level k -> (8, 2^k) int32, views
        of one buffer. children: the (8, 2^(k_top+1)) digests below k_top or
        None (then k_top carries columns); columns_by_log: level -> (C,
        2^level) int32 matrix (rows may be a slice of a larger matrix)."""
        _check_tree(children, columns_by_log, k_top)
        devices = set()
        if children is not None:
            _check(children, "children", rows=8)
            if children.data_ptr() % 8 or children.stride(0) % 2:
                raise ValueError("Blake2s tree: children rows must be 8-byte aligned "
                                 f"(stride {children.stride(0)})")
            devices.add(children.device)
        for k, mat in columns_by_log.items():
            _check(mat, f"level {k} columns")
            if mat.stride(0) * (mat.shape[0] - 1) + (1 << k) > 1 << 32:
                raise ValueError(f"Blake2s tree: level {k} columns span more than 2^32 words")
            devices.add(mat.device)
        if len(devices) != 1:
            raise ValueError(f"Blake2s tree: tensors on several devices: {devices}")
        dev = devices.pop()
        lib = self.lib.load()
        stages, n_counters = tree_stages(k_top, _wave(dev))
        buf, views = _tree_buffer(k_top, n_counters, dev)
        n = k_top + 1
        mats = [columns_by_log.get(k) for k in range(n)]
        ptrs = (ctypes.c_void_p * n)(*[None if m is None else m.data_ptr() for m in mats])
        strides = (ctypes.c_longlong * n)(*[0 if m is None else m.stride(0) for m in mats])
        counts = (ctypes.c_int * n)(*[0 if m is None else m.shape[0] for m in mats])
        table = (ctypes.c_int * (4 * len(stages)))(*[v for s in stages for v in s])
        with torch.cuda.device(dev):
            rc = lib.blake2s_tree(
                None if children is None else children.data_ptr(),
                0 if children is None else children.stride(0), k_top, ptrs, strides, counts,
                table, len(stages), buf.data_ptr(), buf[8 * ((2 << k_top) - 1):].data_ptr(),
                n_counters, torch.cuda.current_stream(dev).cuda_stream)
        _rc(rc, "tree")
        self.launches["tree"] += 1
        return views

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

    def grind(self, digest: bytes, pow_bits: int, device) -> int:
        """The smallest nonce whose Blake2s(digest || nonce_le8) has pow_bits
        low zero bits in its first word: one launch of GRIND_CTAS_A_SM
        persistent CTAs an SM over GRIND_SPAN nonces (the digest passed by
        value, the hit kept with atomicMin), then 4 bytes come back."""
        if len(digest) != 32 or not 0 <= pow_bits <= 32:
            raise ValueError(f"Blake2s grind: a 32-byte digest and 0..32 bits, got "
                             f"{len(digest)} bytes and {pow_bits} bits")
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"the Blake2s grind kernel runs on a CUDA device, got {dev}")
        lib = self.lib.load()
        words = (ctypes.c_uint * 8)(*np.frombuffer(digest, dtype="<u4").tolist())
        best = torch.empty(1, dtype=torch.int32, device=dev)
        mask = (1 << pow_bits) - 1
        ctas = _sms(dev) * GRIND_CTAS_A_SM
        base = 0
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            while base < 1 << 48:  # unreachable for sane pow_bits
                rc = lib.blake2s_grind(words, base, GRIND_SPAN, mask, ctas, best.data_ptr(),
                                       stream)
                _rc(rc, "grind")
                self.launches["grind"] += 1
                with tracing.sync("grind"):
                    hit = int(best.item()) & 0xFFFFFFFF
                if hit != _NO_HIT:
                    return base + hit
                base += GRIND_SPAN
        raise RuntimeError("PoW grind exhausted")

    def chain(self, n: int, chain: int, device) -> torch.Tensor:
        """The timing probe: `chain` dependent compressions on each of n
        threads (256 a CTA, or n if fewer); (n,) int32 out. Off every path,
        so not counted."""
        dev = torch.device(device)
        if dev.type != "cuda" or n <= 0 or chain < 0:
            raise ValueError(f"Blake2s chain probe: {n} threads, chain {chain} on {dev}")
        lib = self.lib.load()
        out = torch.empty(n, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.blake2s_chain(out.data_ptr(), n, chain,
                                   torch.cuda.current_stream(dev).cuda_stream)
        _rc(rc, "chain")
        return out


KERNELS = Blake2sKernels()


# ---------------------------------------------------------------------------
# The schedule of one tree
# ---------------------------------------------------------------------------

def launch_plan(sig: Sequence[Tuple[int, int]], max_log: Optional[int] = None) -> List[tuple]:
    """The launches that hash levels max_log .. 0 of a tree whose columns
    sit at the levels of `sig` [(level, n_cols), ...] (max_log: the deepest
    level hashed, max(sig) by default; deeper digests may feed it): one
    ("tree", max_log) step, whatever levels carry columns."""
    by = dict(sig)
    if max_log is None:
        if not by:
            raise ValueError("launch_plan: a tree without columns needs max_log")
        max_log = max(by)
    if any(k > max_log or k < 0 for k in by):
        raise ValueError(f"launch_plan: column levels {sorted(by)} outside {max_log} .. 0")
    if not max_log <= MAX_LEVEL:
        raise ValueError(f"launch_plan: level {max_log} above {MAX_LEVEL}")
    return [("tree", max_log)]


TreeFn = Callable[[Optional[torch.Tensor], Dict[int, torch.Tensor], int], Dict[int, torch.Tensor]]


def walk_plan(plan: List[tuple], columns_by_log: Dict[int, torch.Tensor],
              prev: Optional[torch.Tensor], tree: TreeFn) -> Dict[int, torch.Tensor]:
    """Run `plan` from the digests `prev` below its first level (None at a
    tree's deepest level) with `tree` (the kernel or a plain version):
    level k -> (8, 2^k) digests."""
    layers: Dict[int, torch.Tensor] = {}
    for kind, k_top in plan:
        if kind != "tree":
            raise ValueError(f"walk_plan: unknown step {kind}")
        layers.update(tree(prev, columns_by_log, k_top))
        prev = layers[0]
    return layers


# ---------------------------------------------------------------------------
# Plain versions (hash_parts, the kernels' layout) and the kernel replayed
# ---------------------------------------------------------------------------

def level_plain(children: Optional[torch.Tensor], columns: Optional[torch.Tensor],
                n_bytes: Optional[int] = None) -> torch.Tensor:
    """What the level kernel computes, and each level of a tree: each
    node's message read word by word as the kernels read it
    (children[w][2i], children[w][2i+1], then columns[c][i]), hashed with
    the plain hash_parts."""
    parts = []
    if children is not None:
        parts += [children[:, 0::2], children[:, 1::2]]
    if columns is not None:
        parts.append(columns)
    return blake2s.words_to_int32(blake2s.hash_parts(parts, n_bytes))


def tree_plain(children: Optional[torch.Tensor], columns_by_log: Dict[int, torch.Tensor],
               k_top: int) -> Dict[int, torch.Tensor]:
    """What the tree kernel computes: levels k_top .. 0, each hashed from
    the one below with level_plain and written to its slice of one buffer
    (on the inputs' device)."""
    _check_tree(children, columns_by_log, k_top)
    device = (children if children is not None else columns_by_log[k_top]).device
    _, views = _tree_buffer(k_top, 0, device)
    prev = children
    for k in range(k_top, -1, -1):
        views[k].copy_(level_plain(prev, columns_by_log.get(k)))
        prev = views[k]
    return views


def emulate_tree(children: Optional[torch.Tensor], columns_by_log: Dict[int, torch.Tensor],
                 k_top: int, wave: int = H100_SMS * CTAS_A_SM, subtree_log: int = SUBTREE_LOG,
                 keep_log: int = KEEP_LOG, seed: int = 0) -> Dict[int, torch.Tensor]:
    """The tree kernel replayed with the plain hash, stage by stage: the
    stage's CTAs in a random arrival order (from seed), CTA c hashing nodes
    c * n .. c * n + n - 1 of each level it carries (n halving a level),
    its top's children read from device memory (the caller's, or the
    buffer the stage before wrote), the levels above from its own "shared"
    level; every level written to its buffer slice; arrivals counted as
    the kernel counts them, the last of a group going on. (A stage's CTAs
    are hashed together, one plain call a level: they own disjoint nodes.)
    Raises if a node is written other than once, a CTA's shared level
    outgrows the kernel's buffers, or the carriers are not exactly the next
    stage's CTAs."""
    _check_tree(children, columns_by_log, k_top)
    device = (children if children is not None else columns_by_log[k_top]).device
    stages, n_counters = tree_stages(k_top, wave, subtree_log, keep_log)
    _, views = _tree_buffer(k_top, 0, device)
    written = {k: np.zeros(1 << k, dtype=np.int64) for k in views}
    counters = [0] * n_counters
    rng = np.random.default_rng(seed)
    ctas = list(range(1 << stages[0][2]))
    for j, (top, bottom, cta_log, _) in enumerate(stages):
        if sorted(ctas) != list(range(1 << cta_log)):
            raise AssertionError(f"stage {j}: CTAs {sorted(ctas)} carried, not 2^{cta_log}")
        order = rng.permutation(ctas)
        shared = None
        for k in range(top, bottom - 1, -1):
            n = 1 << (k - cta_log)
            if n > (1 << SUBTREE_LOG) >> min(top - k, 1):
                raise AssertionError(f"level {k}: {n} nodes a CTA outgrow shared memory")
            nodes = (order[:, None] * n + np.arange(n)).reshape(-1)  # CTA by CTA
            idx = torch.as_tensor(nodes, device=device)
            if k == top:
                src = children if j == 0 else views[k + 1]
                kids = None if src is None else src[:, torch.stack([2 * idx, 2 * idx + 1], 1).reshape(-1)]
            else:
                kids = shared
            cols = columns_by_log.get(k)
            shared = level_plain(kids, None if cols is None else cols[:, idx])
            views[k][:, idx] = shared
            np.add.at(written[k], nodes, 1)
        if cta_log == 0:
            continue
        nxt = stages[j + 1]
        g = cta_log - nxt[2]
        carried = []
        for cta in order.tolist():
            slot = nxt[3] + (cta >> g)
            counters[slot] += 1
            if counters[slot] == 1 << g:
                carried.append(cta >> g)
        ctas = carried
    for k, w in written.items():
        if not (w == 1).all():
            raise AssertionError(f"level {k}: nodes written {sorted(set(w.tolist()))} times")
    return views


def emulate_commit(columns_by_log: Dict[int, torch.Tensor], wave: int = H100_SMS * CTAS_A_SM,
                   subtree_log: int = SUBTREE_LOG, keep_log: int = KEEP_LOG,
                   seed: int = 0) -> Tuple[bytes, Dict[int, torch.Tensor]]:
    """The root and layers of merkle.commit as the tree kernel computes
    them: launch_plan's step replayed with emulate_tree (on the columns'
    device)."""
    plan = launch_plan([(k, m.shape[0]) for k, m in columns_by_log.items()])
    layers = walk_plan(plan, columns_by_log, None,
                       lambda c, cols, k: emulate_tree(c, cols, k, wave, subtree_log, keep_log,
                                                       seed))
    return blake2s.digest_to_bytes(layers[0][:, 0]), layers


def grind_order(ctas: int, span: int, tile: int = GRIND_TILE) -> List[List[int]]:
    """The grind kernel's tiles: CTA c's first nonces (offsets), in the order
    it takes them (c, c + ctas, c + 2 ctas, ... times `tile`, below span)."""
    return [list(range(c * tile, span, ctas * tile)) for c in range(ctas)]


def emulate_grind(digest: bytes, pow_bits: int, ctas: int = H100_SMS * GRIND_CTAS_A_SM,
                  tile: int = GRIND_TILE, span: int = 1 << 20, seed: int = 0) -> Tuple[int, int]:
    """The grind kernel replayed with hashlib: the CTAs of grind_order in a
    random interleaving (from seed), each step one CTA either reading best
    and taking its next tile (or stopping, if best is below the tile's
    first nonce) or hashing the tile it took and atomicMin-ing its hits
    into best. Returns (the nonce found, the nonces hashed); raises if no
    nonce below span is valid."""
    mask = (1 << pow_bits) - 1
    queues = [iter(q) for q in grind_order(ctas, span, tile)]
    taken: List[Optional[int]] = [None] * ctas
    live = list(range(ctas))
    best, hashed = _NO_HIT, 0
    rng = np.random.default_rng(seed)
    while live:
        c = live[int(rng.integers(len(live)))]
        if taken[c] is None:
            start = next(queues[c], None)
            if start is None or best < start:
                live.remove(c)
            else:
                taken[c] = start
            continue
        for i in range(taken[c], min(taken[c] + tile, span)):
            h = hashlib.blake2s(digest + struct.pack("<Q", i)).digest()
            hashed += 1
            if int.from_bytes(h[:4], "little") & mask == 0:
                best = min(best, i)
        taken[c] = None
    if best == _NO_HIT:
        raise RuntimeError(f"emulated grind: no valid nonce below {span}")
    return best, hashed
