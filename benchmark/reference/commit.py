"""Commitment roots worked out again in plain PyTorch: the circle FFT's
low-degree extension, Blake2s, and the mixed-degree Merkle tree.

A frozen copy of the plain (staged, int64) versions that the port keeps as
its kernels' references (core/fft.py, core/blake2s.py, the Merkle level
rule of core/merkle.py), so that it runs on the card or the CPU alike and
shares no code with the program. Evaluations are stored in bit-reversed
order of the canonic domain's natural order [half coset, -half coset].

A column of trace size 2^n, blown up by 2^b, enters its tree at level
n + b; node (k, i) = blake2s(child (k+1, 2i) || child (k+1, 2i+1) || the
values of every level-k column at row i), words little-endian.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .field import M31_CIRCLE_LOG_ORDER, P_INT, CanonicCoset, point_at_index

MASK = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# M31 tensors (int64, canonical)
# ---------------------------------------------------------------------------


def tensor_inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) elementwise (0 -> 0)."""
    result = torch.ones_like(a)
    base = a % P_INT
    e = P_INT - 2
    while e:
        if e & 1:
            result = result * base % P_INT
        base = base * base % P_INT
        e >>= 1
    return result


def bit_reverse_indices(log_size: int, device) -> torch.Tensor:
    idx = torch.arange(1 << log_size, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_size):
        rev |= ((idx >> b) & 1) << (log_size - 1 - b)
    return rev


def coset_points(initial_index: int, log_size: int, device):
    """(x, y) int64 tensors of the coset G^(initial + k step), natural order."""
    step = 1 << (M31_CIRCLE_LOG_ORDER - log_size)
    x0, y0 = point_at_index(initial_index)
    xs = torch.tensor([x0], dtype=torch.int64, device=device)
    ys = torch.tensor([y0], dtype=torch.int64, device=device)
    for b in range(log_size):
        dx, dy = point_at_index(step << b)
        nx = (xs * dx - ys * dy) % P_INT
        ny = (xs * dy + ys * dx) % P_INT
        xs = torch.cat([xs, nx])
        ys = torch.cat([ys, ny])
    return xs, ys


def domain_points_storage(log_size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) of the canonic domain of size 2^log_size in storage order."""
    half = CanonicCoset(log_size).circle_domain().half_coset
    hx, hy = coset_points(half.initial_index, half.log_size, device)
    xs = torch.cat([hx, hx])
    ys = torch.cat([hy, (-hy) % P_INT])
    rev = bit_reverse_indices(log_size, device)
    return xs[rev], ys[rev]


def twiddle_stages(log_size: int, inverse: bool, device) -> List[torch.Tensor]:
    """Per-stage twiddles in bit-reversed block order: y of the half coset
    for stage 0, pi^(L-1)(x) for stage L >= 1, pi(x) = 2x^2 - 1."""
    half = CanonicCoset(log_size).circle_domain().half_coset
    hx, hy = coset_points(half.initial_index, half.log_size, device)
    stages = [hy[bit_reverse_indices(log_size - 1, device)]]
    x = hx
    for L in range(1, log_size):
        cnt = 1 << (log_size - 1 - L)
        x = x[: 2 * cnt]
        stages.append(x[:cnt][bit_reverse_indices(log_size - 1 - L, device)])
        x = (2 * (x * x % P_INT) + P_INT - 1) % P_INT
    if inverse:
        stages = [tensor_inv(t) for t in stages]
    return stages


def interpolate(values: torch.Tensor, n: int) -> torch.Tensor:
    """Evaluations (C, 2^n) in storage order -> coefficients, int64."""
    tws = twiddle_stages(n, True, values.device)
    lead = tuple(values.shape[:-1])
    v = values.to(torch.int64)
    for L in range(n):
        blocks = 1 << (n - 1 - L)
        v = v.reshape(lead + (blocks, 2, 1 << L))
        a, b = v[..., 0, :], v[..., 1, :]
        t = tws[L].reshape(blocks, 1)
        v = torch.stack([(a + b) % P_INT, ((a - b) % P_INT) * t % P_INT], dim=-2)
        v = v.reshape(lead + (1 << n,))
    scale = pow((P_INT + 1) // 2, n, P_INT)
    return v * scale % P_INT


def evaluate(coeffs: torch.Tensor, n: int) -> torch.Tensor:
    """Coefficients (C, 2^n) -> evaluations in storage order, int64."""
    tws = twiddle_stages(n, False, coeffs.device)
    lead = tuple(coeffs.shape[:-1])
    v = coeffs.to(torch.int64)
    for L in reversed(range(n)):
        blocks = 1 << (n - 1 - L)
        v = v.reshape(lead + (blocks, 2, 1 << L))
        a, b = v[..., 0, :], v[..., 1, :]
        tb = b * tws[L].reshape(blocks, 1) % P_INT
        v = torch.stack([(a + tb) % P_INT, (a - tb) % P_INT], dim=-2)
        v = v.reshape(lead + (1 << n,))
    return v


def extend(values: torch.Tensor, n: int, log_blowup: int) -> torch.Tensor:
    """Low-degree extension of (C, 2^n) evaluations onto the domain of size
    2^(n + log_blowup): interpolate, zero-pad the coefficients, evaluate.
    int32 out."""
    coeffs = interpolate(values, n)
    padded = torch.zeros(coeffs.shape[:-1] + (1 << (n + log_blowup),), dtype=torch.int64,
                         device=coeffs.device)
    padded[..., : 1 << n] = coeffs
    del coeffs
    return evaluate(padded, n + log_blowup).to(torch.int32)


def is_first_extended(log_size: int, eval_log: int, device) -> torch.Tensor:
    """The is_first column of trace size 2^log_size (1 at the first domain
    point, 0 elsewhere) extended onto the domain of size 2^eval_log: its
    interpolant factors over the bits of the coefficient index, so the
    extension is prod_b (1 + itw_b * phi_b(p)) / 2^log_size with phi_0 = y
    and phi_b = pi^(b-1)(x)."""
    half = CanonicCoset(log_size).circle_domain().half_coset
    x, y = point_at_index(half.initial_index)
    tws = [y]
    for _ in range(1, log_size):
        tws.append(x)
        x = (2 * x * x + P_INT - 1) % P_INT
    itws = [pow(t, P_INT - 2, P_INT) for t in tws]
    xs, ys = domain_points_storage(eval_log, device)
    f = (1 + ys * itws[0]) % P_INT
    cur = xs
    for b in range(1, log_size):
        f = f * ((1 + cur * itws[b]) % P_INT) % P_INT
        if b + 1 < log_size:
            cur = (2 * (cur * cur % P_INT) + P_INT - 1) % P_INT
    return (f * pow((P_INT + 1) // 2, log_size, P_INT) % P_INT).to(torch.int32)


# ---------------------------------------------------------------------------
# Blake2s over many messages at once (int64 words, masked to 32 bits)
# ---------------------------------------------------------------------------

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
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


def _compress(h: List[torch.Tensor], m: torch.Tensor, t: int, last: bool) -> List[torch.Tensor]:
    v = list(h) + [torch.full_like(h[0], c) for c in IV]
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


def blake2s_words(words: torch.Tensor) -> torch.Tensor:
    """BLAKE2s-256 of N messages of W 32-bit words each, given as a (W, N)
    tensor (int32 rows read as bit patterns). Returns (8, N) int64."""
    w, n = words.shape
    n_blocks = max(1, -(-w // 16))
    h = [torch.full((n,), c, dtype=torch.int64, device=words.device) for c in H0]
    for b in range(n_blocks):
        blk = words[16 * b: 16 * b + 16].to(torch.int64) & MASK
        if blk.shape[0] < 16:
            blk = torch.cat([blk, blk.new_zeros((16 - blk.shape[0], n))])
        last = b == n_blocks - 1
        h = _compress(h, blk, 4 * w if last else 64 * (b + 1), last)
    return torch.stack(h)


def merkle_root(columns_by_level: Dict[int, torch.Tensor]) -> bytes:
    """Root of the tree over level -> (C, 2^level) int32 columns."""
    top = max(columns_by_level)
    digests = None
    for k in range(top, -1, -1):
        parts = []
        if digests is not None:
            pairs = digests.reshape(8, 1 << k, 2)
            parts += [pairs[:, :, 0], pairs[:, :, 1]]
        if k in columns_by_level:
            parts.append(columns_by_level[k].to(torch.int64) & MASK)
        digests = blake2s_words(torch.cat(parts) if len(parts) > 1 else parts[0])
    return (digests[:, 0].cpu().numpy() & MASK).astype("<u4").tobytes()


# ---------------------------------------------------------------------------
# The roots the verifier recomputes
# ---------------------------------------------------------------------------


def ladder_root(ladder: Sequence[int], log_blowup: int, device) -> bytes:
    """The preprocessed tree: one is_first column a ladder size."""
    return merkle_root({lg + log_blowup: is_first_extended(lg, lg + log_blowup, device)[None]
                        for lg in ladder})


def trace_root(columns: Sequence[Tuple[int, np.ndarray]], log_blowup: int, device) -> bytes:
    """The tree of (log size, column) trace columns, each extended by the
    blowup; columns of one size keep their order."""
    by_log: Dict[int, List[np.ndarray]] = {}
    for lg, col in columns:
        by_log.setdefault(lg, []).append(col)
    levels = {}
    for lg, cols in by_log.items():
        vals = torch.as_tensor(np.stack(cols).astype(np.int64), device=device)
        levels[lg + log_blowup] = extend(vals, lg, log_blowup)
        del vals
    return merkle_root(levels)

