"""Sharded circle FFT: evaluation and interpolation over a mesh.

Counterpart of ``stwo_brainfuck_tpu/parallel/fft_sharded.py``. The
evaluation array (bit-reversed storage) is split into D contiguous chunks
of 2^local positions, local = n - log2 D. Stage L has butterfly stride 2^L:

- local stages (L < local): a butterfly block never crosses a chunk, so
  shard i runs them on its chunk as a 2^local transform whose stage-L
  twiddles are the slice [i·2^(local-1-L), (i+1)·2^(local-1-L)) of the
  global stage L: the circle-FFT kernel with the shard's table on a CUDA
  shard, the plain staged version with the shard's stages on a CPU shard
  (``ops/circle_fft.shard_evaluate`` / ``shard_interpolate``);
- cross stages (L >= local, the top log2 D stages): every position of a
  shard shares one block and one twiddle; partners are shards i and
  i ^ dist, dist = 2^(L-local). One exchange per stage; the lower shard
  computes u0 = a + t·b, the upper u1 = a - t·b (elementwise torch ops,
  as the JAX package leaves them to XLA).

The inverse runs the local stages unscaled, then the cross stages, then the
global 2^-n. A transform takes an (N,) or a (C, N) array, sharded or not,
and returns a Sharded array.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch

from ..core import fft, m31
from ..core.m31 import P_INT
from ..ops import circle_fft
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


@lru_cache(maxsize=64)
def make_sharded_evaluate(mesh: Mesh, log_size: int):
    """fn: coefficients (natural order) -> evaluation (bit-reversed
    storage), both sharded over the mesh; int32."""
    n = log_size
    local = _local_log(mesh, n)
    cross = _cross_twiddles(n, mesh.size, False)

    def fn(coeffs) -> Sharded:
        v = mesh.as_sharded(coeffs).shards
        for k, L in enumerate(range(n - 1, local - 1, -1)):
            dist = 1 << (L - local)
            other = mesh.exchange(v, dist)
            # the lower shard holds a (gets a + t·b), the upper b (a - t·b)
            v = [(m31.add(mine, m31.mul(theirs, t)) if i & dist == 0
                  else m31.sub(theirs, m31.mul(mine, t))).to(torch.int32)
                 for i, (mine, theirs, t) in enumerate(zip(v, other, cross[k]))]
        return Sharded(mesh, [circle_fft.shard_evaluate(x.contiguous(), n, mesh.size, i)
                              for i, x in enumerate(v)])

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
        v = [circle_fft.shard_interpolate(x.contiguous(), n, mesh.size, i)
             for i, x in enumerate(mesh.as_sharded(values).shards)]
        for L in range(local, n):
            dist = 1 << (L - local)
            other = mesh.exchange(v, dist)
            # the lower shard holds a (gets a + b), the upper b ((a - b)/t)
            v = [(m31.add(mine, theirs) if i & dist == 0
                  else m31.mul(m31.sub(theirs, mine), t)).to(torch.int32)
                 for i, (mine, theirs, t) in enumerate(zip(v, other, cross[n - 1 - L]))]
        return Sharded(mesh, [m31.mul(x, scale).to(torch.int32) for x in v])

    return fn


def sharded_extend(mesh: Mesh, values, log_size: int, log_blowup: int):
    """(coefficients, evaluation on the 2^log_blowup times larger domain),
    both sharded: interpolate, zero-pad (each chunk of coefficients moves
    to the shard that owns its positions), evaluate."""
    coeffs = make_sharded_interpolate(mesh, log_size)(values)
    padded = mesh.pad(coeffs, log_size + log_blowup)
    return coeffs, make_sharded_evaluate(mesh, log_size + log_blowup)(padded)
