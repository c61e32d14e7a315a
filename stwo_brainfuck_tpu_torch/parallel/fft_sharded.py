"""Sharded circle FFT: evaluation and interpolation over a mesh.

Counterpart of ``stwo_brainfuck_tpu/parallel/fft_sharded.py``. The
evaluation array (bit-reversed storage) is split into D contiguous chunks
of 2^local positions, local = n - log2 D. Stage L has butterfly stride 2^L:

- local stages (L < local): a butterfly block never crosses a chunk, so
  shard i runs them on its chunk as a 2^local transform whose stage-L
  twiddles are the slice [i·2^(local-1-L), (i+1)·2^(local-1-L)) of the
  global stage L: the circle-FFT kernel with the shard's table on a CUDA
  shard, the plain staged version with the shard's stages on a CPU shard
  (``ops/circle_fft.shard_evaluate`` / ``shard_interpolate``), on the
  shards this process owns;
- cross stages (L >= local, the top log2 D stages): every position of a
  shard shares one block and one twiddle; partners are shards i and
  i ^ dist, dist = 2^(L-local). The lower shard computes u0 = a + t·b,
  the upper u1 = a - t·b (``ops/mesh_kernels``: in place on the shard's
  int32 buffer, the mesh-stage kernel on a CUDA shard, the plain version
  on a CPU shard). A stage goes a chunk of whole columns at a time (at
  most EXCHANGE_BYTES, at least one column): each chunk is one exchange
  into a receive buffer that every chunk reuses, then one stage launch
  over the chunk (a span ``fft.cross``), so a stage holds at most one
  chunk of the partner and no widened temporary.

The inverse runs the local stages unscaled, then the cross stages, the last
of them with the global 2^-n folded in (without cross stages, the local
stages scale). A transform takes an (N,) or a (C, N) array, sharded or not,
and returns a Sharded array; the evaluate works in place on its input's
shards where the caller gives them up (``consume``), else its first stage
writes a new buffer.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, List, Optional, Tuple

import torch

from .. import tracing
from ..core import fft
from ..core.m31 import P_INT
from ..ops import circle_fft, mesh_kernels
from .mesh import Mesh, Sharded


@lru_cache(maxsize=64)
def _cross_twiddles(log_size: int, n_shards: int, inverse: bool) -> Tuple[Tuple[int, ...], ...]:
    """Per-shard twiddle of each cross stage, stages n-1 down to local:
    entry [k][i] is the stage-(n-1-k) twiddle of shard i's block (its
    inverse for the interpolate; the 2^-n is applied once, at the end)."""
    n = log_size
    local = n - (n_shards.bit_length() - 1)
    out = []
    for L in range(n - 1, local - 1, -1):
        vals = [fft.twiddle_at(n, L, (i << local) >> (L + 1)) for i in range(n_shards)]
        out.append(tuple(pow(v, P_INT - 2, P_INT) if inverse else v for v in vals))
    return tuple(out)


def _local_log(mesh: Mesh, log_size: int) -> int:
    local = log_size - mesh.split_log
    if local < 1:
        raise ValueError(f"a 2^{log_size} transform does not split over {mesh.size} shards")
    return local


# The most a cross stage receives from its partner at once: one column of
# a (4, 2^30) transform over four shards. Smaller columns go together, so
# a stage makes few exchanges and launches.
EXCHANGE_BYTES = 1 << 30


def cross_stage(mesh: Mesh, v: List[Optional[torch.Tensor]], dist: int,
                apply: Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor], None],
                out: Optional[List[Optional[torch.Tensor]]] = None) -> None:
    """One cross stage over contiguous (..., c) shards, a chunk of whole
    columns at a time (EXCHANGE_BYTES at most, one column at least): every
    shard receives its partner's (i ^ dist) chunk into one reused buffer,
    then apply(i, own chunk, partner's chunk, output chunk), each a flat
    view, writes the stage's values (into `out`'s shards where given, else
    into v's)."""
    out = v if out is None else out
    rows = mesh.each(lambda i: v[i].reshape(-1, v[i].shape[-1]))
    dst = mesh.each(lambda i: out[i].reshape(-1, out[i].shape[-1]))
    n_rows, c = rows[mesh.local[0]].shape
    per = max(1, min(n_rows, EXCHANGE_BYTES // (4 * c)))
    recv = mesh.each(lambda i: torch.empty(per * c, dtype=torch.int32, device=mesh.device(i)))
    for j in range(0, n_rows, per):
        k = min(n_rows, j + per)
        own = mesh.each(lambda i: rows[i][j:k].reshape(-1))
        got = mesh.exchange(own, dist, out=mesh.each(lambda i: recv[i][:(k - j) * c]))
        with tracing.span("fft.cross"):
            for i in mesh.local:
                apply(i, own[i], got[i], dst[i][j:k].reshape(-1))


def _int32_shards(mesh: Mesh, x) -> List[Optional[torch.Tensor]]:
    return mesh.each(lambda i: x[i].to(torch.int32).contiguous())


@lru_cache(maxsize=64)
def make_sharded_evaluate(mesh: Mesh, log_size: int):
    """fn(coeffs, consume=False): coefficients (natural order) ->
    evaluation (bit-reversed storage), both sharded over the mesh; int32.
    With `consume` the caller gives up a Sharded input: the cross stages
    overwrite its shards."""
    n = log_size
    local = _local_log(mesh, n)
    cross = _cross_twiddles(n, mesh.size, False)

    def fn(coeffs, consume: bool = False) -> Sharded:
        v = _int32_shards(mesh, mesh.as_sharded(coeffs).shards)
        owned = consume
        for k, L in enumerate(range(n - 1, local - 1, -1)):
            dist = 1 << (L - local)
            t = cross[k]
            # the lower shard holds a (gets a + t·b), the upper b (a - t·b)
            out = v if owned else mesh.each(lambda i: torch.empty_like(v[i]))
            cross_stage(mesh, v, dist, lambda i, a, b, o: mesh_kernels.evaluate_cross(
                a, b, t[i], bool(i & dist), out=o), out)
            v, owned = out, True
        return Sharded(mesh, mesh.each(
            lambda i: circle_fft.shard_evaluate(v[i], n, mesh.size, i)))

    return fn


@lru_cache(maxsize=64)
def make_sharded_interpolate(mesh: Mesh, log_size: int):
    """fn: evaluation (bit-reversed storage) -> coefficients (natural
    order), both sharded over the mesh; int32."""
    n = log_size
    local = _local_log(mesh, n)
    cross = _cross_twiddles(n, mesh.size, True)
    scale = fft.inv_pow2(n)

    def fn(values) -> Sharded:
        x = mesh.as_sharded(values).shards
        if local == n:  # one shard: no cross stage, the local stages scale
            return Sharded(mesh, mesh.each(lambda i: circle_fft.shard_interpolate(
                x[i].to(torch.int32).contiguous(), n, 1, i, scale=scale)))
        v = mesh.each(lambda i: circle_fft.shard_interpolate(
            x[i].to(torch.int32).contiguous(), n, mesh.size, i))
        for L in range(local, n):
            dist = 1 << (L - local)
            t = cross[n - 1 - L]
            s = scale if L == n - 1 else 1
            # the lower shard holds a (gets a + b), the upper b ((a - b)/t)
            cross_stage(mesh, v, dist, lambda i, a, b, o: mesh_kernels.interpolate_cross(
                a, b, t[i], bool(i & dist), scale=s, out=o))
        return Sharded(mesh, v)

    return fn


def sharded_extend(mesh: Mesh, values, log_size: int, log_blowup: int):
    """(coefficients, evaluation on the 2^log_blowup times larger domain),
    both sharded: interpolate, zero-pad (each chunk of coefficients moves
    to the shard that owns its positions), evaluate in place on the
    padded copy."""
    coeffs = make_sharded_interpolate(mesh, log_size)(values)
    padded = mesh.pad(coeffs, log_size + log_blowup)
    return coeffs, make_sharded_evaluate(mesh, log_size + log_blowup)(padded, consume=True)
