"""Circle FFT (CFFT): interpolation and evaluation of circle polynomials on
canonic circle domains, on torch tensors.

Counterpart of ``stwo_brainfuck_tpu/core/fft.py``. Layout and basis are the
same: evaluations are stored in BIT-REVERSED order of the domain's natural
order [half_coset, -half_coset]; coefficient j (bits j0..j_{n-1}) multiplies
y^{j0} * x^{j1} * pi(x)^{j2} * ... with pi(x) = 2x^2 - 1, so zero-padding
coefficients and evaluating on a larger domain is low-degree extension.

``interpolate``/``evaluate``/``extend_with_coeffs`` dispatch through
``ops/circle_fft.py``: a CUDA tensor goes to the hand-written Hopper kernel,
a CPU tensor to the plain staged version below (``evaluate_plain`` /
``interpolate_plain``). The plain versions are the kernel's reference.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

import torch

from . import m31
from .circle import M31_CIRCLE_LOG_ORDER, CanonicCoset, point_at_index

P_INT = m31.P_INT

# Calls of the plain staged transform on CUDA tensors. The prover never
# makes one (CUDA tensors go to the kernel); chip_smoke.py checks that.
PLAIN_CUDA_CALLS = 0


def bit_reverse_indices(log_size: int, device) -> torch.Tensor:
    """Permutation out[i] = bitrev(i, log_size), int64 on `device`."""
    idx = torch.arange(1 << log_size, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_size):
        rev |= ((idx >> b) & 1) << (log_size - 1 - b)
    return rev


def bitrev_int(x: int, bits: int) -> int:
    """Bit-reverse of a single index."""
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def coset_points(initial_index: int, log_size: int, device):
    """(x, y) int64 tensors of Coset(initial_index, log_size) in natural
    order, built on `device` by doubling: the points of k < 2^b shifted by
    2^b steps give those of 2^b <= k < 2^(b+1)."""
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


def twiddle_stages(log_size: int, inverse: bool, device: str) -> list:
    """Per-stage twiddles of the canonic domain of size 2^log_size, int64
    on `device`, in bit-reversed block order (the JAX package's
    get_twiddles(log_size).fwd, or .inv when `inverse`): stage L has
    2^(log_size-1-L) entries, y of the half coset for L = 0 and
    pi^(L-1)(x) for L >= 1, pi(x) = 2x^2 - 1. Built on the device by coset
    doubling: a host stack costs seconds at 2^24. Not cached: the kernel
    keeps only its int32 table (ops/circle_fft.twiddle_table)."""
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
        stages = [m31.inv(t) for t in stages]
    return stages


@lru_cache(maxsize=64)
def get_twiddles(log_size: int, inverse: bool, device: str) -> tuple:
    """twiddle_stages, cached: the plain transforms' twiddles."""
    return tuple(twiddle_stages(log_size, inverse, device))


def inv_pow2(n: int) -> int:
    """(1/2)^n mod p: the interpolation normalization."""
    return pow((P_INT + 1) // 2, n, P_INT)


def _note_plain_call(x: torch.Tensor) -> None:
    global PLAIN_CUDA_CALLS
    if x.is_cuda:
        PLAIN_CUDA_CALLS += 1


def shard_stages(n: int, n_shards: int, i: int, inverse: bool, device: str) -> list:
    """The twiddles of shard i's local stages when a 2^n transform is split
    into n_shards contiguous chunks of 2^local (local = n - log2 n_shards):
    stage L < local is the slice [i·2^(local-1-L), (i+1)·2^(local-1-L)) of
    the global stage L (storage is bit-reversed, so a contiguous chunk's
    butterfly blocks are a contiguous run of twiddles)."""
    local = n - (n_shards.bit_length() - 1)
    tws = get_twiddles(n, inverse, device)
    return [tws[L][i << (local - 1 - L):(i + 1) << (local - 1 - L)] for L in range(local)]


def twiddle_at(n: int, L: int, t: int) -> int:
    """Entry t of the forward stage-L twiddles of the size-2^n domain
    (get_twiddles(n, False, ...)[L][t]), computed on the host from one
    circle point: y of the half coset's point bitrev(t) for L = 0, else
    pi^(L-1) of its x."""
    half = CanonicCoset(n).circle_domain().half_coset
    x, y = half.at(bitrev_int(t, n - 1 - L))
    if L == 0:
        return y
    for _ in range(L - 1):
        x = (2 * x * x + P_INT - 1) % P_INT
    return x


def interpolate_plain(values: torch.Tensor, n: int, stages=None, scale=None) -> torch.Tensor:
    """Staged inverse CFFT over the last axis: stages L = 0 .. n-1, pair
    stride 2^L, (a, b) -> (a + b, (a - b) / t), then · `scale` (default
    2^-n). int32 out. `stages` (default: those of the size-2^n domain)
    gives each stage's inverse twiddles, as shard_stages does for one
    shard of a larger transform."""
    _note_plain_call(values)
    tws = get_twiddles(n, True, str(values.device)) if stages is None else stages
    scale = inv_pow2(n) if scale is None else scale
    lead = tuple(values.shape[:-1])
    v = m31.wide(values)
    for L in range(n):
        blocks = 1 << (n - 1 - L)
        v = v.reshape(lead + (blocks, 2, 1 << L))
        a = v[..., 0, :]
        b = v[..., 1, :]
        t = tws[L].reshape(blocks, 1)
        v = torch.stack([(a + b) % P_INT, ((a - b) % P_INT) * t % P_INT], dim=-2)
        v = v.reshape(lead + (1 << n,))
    return (v * scale % P_INT).to(torch.int32)


def evaluate_plain(coeffs: torch.Tensor, n: int, stages=None) -> torch.Tensor:
    """Staged forward CFFT over the last axis: stages L = n-1 .. 0,
    (a, b) -> (a + t·b, a - t·b). int32 out. `stages` as in
    interpolate_plain (forward twiddles)."""
    _note_plain_call(coeffs)
    tws = get_twiddles(n, False, str(coeffs.device)) if stages is None else stages
    lead = tuple(coeffs.shape[:-1])
    v = m31.wide(coeffs)
    for L in reversed(range(n)):
        blocks = 1 << (n - 1 - L)
        v = v.reshape(lead + (blocks, 2, 1 << L))
        a = v[..., 0, :]
        b = v[..., 1, :]
        tb = b * tws[L].reshape(blocks, 1) % P_INT
        v = torch.stack([(a + tb) % P_INT, (a - tb) % P_INT], dim=-2)
        v = v.reshape(lead + (1 << n,))
    return v.to(torch.int32)


def extend_plain(values: torch.Tensor, n: int, log_blowup: int):
    """interpolate_plain, zero-pad to 2^(n+log_blowup), evaluate_plain:
    (coefficients, blown-up evaluation), int32. The fused kernel's
    reference."""
    coeffs = interpolate_plain(values, n)
    padded = torch.zeros(coeffs.shape[:-1] + (1 << (n + log_blowup),),
                         dtype=torch.int32, device=coeffs.device)
    padded[..., : 1 << n] = coeffs
    return coeffs, evaluate_plain(padded, n + log_blowup)


def _log_of(x: torch.Tensor, log_size) -> int:
    return int(x.shape[-1]).bit_length() - 1 if log_size is None else log_size


def interpolate(values: torch.Tensor, log_size: int | None = None) -> torch.Tensor:
    """Circle evaluation (bit-reversed order, length 2^n) -> coefficients
    (natural order), int32. Inverse of evaluate() on the same-size domain."""
    from ..ops import circle_fft

    return circle_fft.interpolate(values, _log_of(values, log_size))


def evaluate(coeffs: torch.Tensor, log_size: int | None = None) -> torch.Tensor:
    """Coefficients (natural order, length 2^n) -> evaluation on the
    canonic domain of size 2^n in bit-reversed order, int32."""
    from ..ops import circle_fft

    return circle_fft.evaluate(coeffs, _log_of(coeffs, log_size))


def extend_with_coeffs(values: torch.Tensor, log_size: int, log_blowup: int):
    """(coefficients, blown-up evaluation) of a (C, 2^log_size) batch of
    columns. A CPU tensor takes extend_plain (interpolate, zero-pad,
    evaluate); a CUDA tensor takes the fused kernel, which writes no
    padding (ops/circle_fft.extend)."""
    from ..ops import circle_fft

    return circle_fft.extend(values, log_size, log_blowup)


# ---------------------------------------------------------------------------
# Closed-form is_first (Lagrange kernel at the first domain point)
# ---------------------------------------------------------------------------
#
# interpolate(e_0) has Kronecker structure: c_j = (1/N) * prod_{bits b of j}
# invtw_b[0], and the extended evaluation factors as
#   f(p) = (1/N) * prod_{b=0}^{n-1} (1 + invtw_b[0] * phi_b(p)),
#   phi_0 = y, phi_k = pi^(k-1)(x).

def _is_first_tws(n: int) -> List[int]:
    """invtw_b[0] = get_twiddles(n, True, device)[b][0] for b < n. Block 0 of every
    stage is the half coset's first point: fwd[0][0] = y0 and
    fwd[b][0] = pi^(b-1)(x0), so O(n) host work instead of the 2^n stack."""
    half = CanonicCoset(n).circle_domain().half_coset
    x, y = point_at_index(half.initial_index)
    tws = [y]
    for _ in range(1, n):
        tws.append(x)
        x = (2 * x * x + P_INT - 1) % P_INT
    return [pow(t, P_INT - 2, P_INT) for t in tws]


def is_first_coeffs(log_size: int, device) -> torch.Tensor:
    """Coefficients of the is_first column's interpolant (equals
    interpolate(e_0) exactly), int32 on `device`."""
    v = torch.ones(1, dtype=torch.int64, device=device)
    for t in _is_first_tws(log_size):
        v = torch.cat([v, v * t % P_INT])
    return (v * inv_pow2(log_size) % P_INT).to(torch.int32)


def is_first_extended(log_size: int, eval_log: int, device) -> torch.Tensor:
    """is_first's low-degree extension onto the canonic domain of size
    2^eval_log (bit-reversed storage) — closed form, no CFFT. int32."""
    from .quotients import domain_points_storage

    xs, ys = domain_points_storage(eval_log, device)
    tws = _is_first_tws(log_size)
    f = (1 + ys * tws[0]) % P_INT
    cur = xs
    for b in range(1, log_size):
        f = f * ((1 + cur * tws[b]) % P_INT) % P_INT
        if b + 1 < log_size:
            cur = (2 * (cur * cur % P_INT) + P_INT - 1) % P_INT
    return (f * inv_pow2(log_size) % P_INT).to(torch.int32)


def coset_order_permutation(log_size: int, device) -> torch.Tensor:
    """perm[l] = storage position (bit-reversed [H, -H] order) of the l-th
    point of the canonic coset in LINEAR order (point q(1+2l)), int64 on
    `device`: l = 2k is natural index k (in H), l = 2k+1 is natural index
    2^(n-1) + (2^(n-1)-1-k) (in -H, reversed)."""
    half = 1 << (log_size - 1)
    k = torch.arange(half, dtype=torch.int64, device=device)
    nat = torch.stack([k, half + (half - 1 - k)], dim=1).reshape(-1)
    return bit_reverse_indices(log_size, device)[nat]


def rotation_permutation(log_size: int, log_blowup: int, shift_steps: int,
                    device) -> torch.Tensor:
    """Permutation realizing evaluation of f(p - shift_steps * g_n) from the
    evaluations of f on the blown-up domain of size 2^(log_size+log_blowup)
    (both in bit-reversed storage): rotated[j] = values[perm[j]], int64 on
    `device`. The linear-order point l of the canonic domain of size
    2^n_big has circle index q*(2l+1) with q = 2^(30-n_big), and the trace
    step is g_n = q*2^(blowup+1), so subtracting shift_steps*g_n maps
    linear l to (l - shift_steps*2^blowup) mod N."""
    n_big = log_size + log_blowup
    n = 1 << n_big
    cop = coset_order_permutation(n_big, device)
    inv = torch.empty_like(cop)
    inv[cop] = torch.arange(n, dtype=torch.int64, device=device)
    return cop[(inv - (shift_steps << log_blowup)) % n]
