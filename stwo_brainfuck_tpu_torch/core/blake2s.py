"""BLAKE2s-256 over many independent same-length messages, in torch.

Counterpart of ``stwo_brainfuck_tpu/core/blake2s.py``; digests are
bit-identical to ``hashlib.blake2s``. Messages are uint32 word arrays given
WORD-LEADING: a (W, N) tensor holds N messages of W words, row w being word
w of every message (a column matrix (C, 2^k) is already in this layout).
Words are computed in int64 masked to 32 bits (torch has no unsigned 32-bit
arithmetic on the CPU). Messages of more than 16 words run several
compressions with byte counter 64·(b+1), the true length on the last block,
and zero padding.

``hash_parts`` is the plain version: the reference of the hand-written
kernels (``ops/blake2s_kernels.py``, ``csrc/blake2s.cu``), which hash every
CUDA tensor of the Merkle trees, the PoW grind and ``hash_words``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

# h[0] ^= 0x01010000 | digest_length (32); fanout=1 depth=1, no key.
H0 = (IV[0] ^ 0x01010020,) + IV[1:]

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)

# Calls of the plain hash_parts on CUDA tensors. The prover never makes one
# (CUDA tensors go to the kernels); chip_smoke.py checks that.
PLAIN_CUDA_CALLS = 0


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & MASK


def _g(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & MASK
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & MASK
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + y) & MASK
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & MASK
    v[b] = _rotr(v[b] ^ v[c], 7)


def compress(h: List[torch.Tensor], m: torch.Tensor, t: int, last: bool) -> List[torch.Tensor]:
    """One BLAKE2s compression of N states. h: 8 (N,) int64 words; m:
    (16, N) int64 message words; t: byte counter after this block."""
    full = lambda c: torch.full_like(h[0], c)  # noqa: E731
    v = list(h) + [full(c) for c in IV]
    v[12] = v[12] ^ (t & MASK)
    v[13] = v[13] ^ ((t >> 32) & MASK)
    if last:
        v[14] = v[14] ^ MASK
    for s in SIGMA:
        _g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def hash_parts(parts: Sequence[torch.Tensor], n_bytes: int | None = None) -> torch.Tensor:
    """BLAKE2s-256 of N messages whose words are the rows of `parts`
    concatenated (each part (W_i, N), word-leading; int32 rows are read as
    their 32-bit patterns). Returns (8, N) int64 digest words.

    The concatenation is never materialized: each 16-word block gathers its
    rows from the parts, so a wide column matrix costs one block of int64
    at a time."""
    global PLAIN_CUDA_CALLS
    if parts[0].is_cuda:
        PLAIN_CUDA_CALLS += 1
    rows = []  # (part, row) per message word
    for pi, p in enumerate(parts):
        rows.extend((pi, r) for r in range(p.shape[0]))
    w = len(rows)
    n = parts[0].shape[1]
    device = parts[0].device
    total = 4 * w if n_bytes is None else n_bytes
    n_blocks = max(1, -(-w // 16))
    h = [torch.full((n,), c, dtype=torch.int64, device=device) for c in H0]
    for b in range(n_blocks):
        blk = rows[16 * b: 16 * b + 16]
        segs = []
        i = 0
        while i < len(blk):  # runs of consecutive rows of one part
            pi, r0 = blk[i]
            j = i
            while j + 1 < len(blk) and blk[j + 1] == (pi, blk[j][1] + 1):
                j += 1
            segs.append(parts[pi][r0: blk[j][1] + 1])
            i = j + 1
        if len(blk) < 16:
            segs.append(torch.zeros((16 - len(blk), n), dtype=torch.int64, device=device))
        m = torch.cat([s.to(torch.int64) & MASK for s in segs])
        last = b == n_blocks - 1
        h = compress(h, m, total if last else 64 * (b + 1), last)
    return torch.stack(h)


def hash_words(words: torch.Tensor, n_bytes: int | None = None) -> torch.Tensor:
    """BLAKE2s-256 of N messages given as one (W, N) word-leading tensor:
    the plain hash_parts on the CPU, the level kernel (int32 words) on a
    CUDA tensor. Returns (8, N) int64 digest words either way."""
    if words.device.type == "cpu":
        return hash_parts([words], n_bytes)
    if words.device.type != "cuda":
        raise ValueError(f"Blake2s: unsupported device {words.device}")
    from ..ops import blake2s_kernels

    return blake2s_kernels.KERNELS.level(None, words, n_bytes).to(torch.int64) & MASK


def words_to_int32(d: torch.Tensor) -> torch.Tensor:
    """Keep digest words as int32 bit patterns (half the memory)."""
    return torch.where(d >= 1 << 31, d - (1 << 32), d).to(torch.int32)


def digest_to_bytes(digest_words) -> bytes:
    """(8,) digest words (any int dtype, 32-bit patterns) -> 32 bytes."""
    if isinstance(digest_words, torch.Tensor):
        digest_words = digest_words.cpu().to(torch.int64).numpy()
    return (np.asarray(digest_words, np.int64) & MASK).astype("<u4").tobytes()
