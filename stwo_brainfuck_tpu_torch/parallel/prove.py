"""ShardedOps: the multi-device backend of prove_brainfuck.

Counterpart of ``stwo_brainfuck_tpu/parallel/prove.py``.
``air.prove_brainfuck(machine, mesh=mesh)`` routes every heavy phase
through this object:

- LogUp fractions and prefix sums: per shard, with the permutation to and
  from linear order as a global gather (``Mesh.permute``) and the shard
  totals all-gathered (parallel/sharded.py);
- circle-FFT interpolate / extend / evaluate: parallel/fft_sharded.py (the
  FFT kernel on every shard's local stages, exchanges for the cross-shard
  stages);
- Merkle commitments: parallel/merkle_sharded.commit_sharded;
- composition constraints, quotient accumulation and OODS sampling: per
  shard (the samples as per-shard partial contractions, one mesh sum, mod
  p);
- FRI folds: per shard (fold pairs are adjacent in bit-reversed storage,
  so a shard's chunk folds to a chunk, until the layer is smaller than the
  mesh and finishes whole).

Each process works on the shards it owns (``Mesh.each``). All arithmetic
is exact mod p, so the proof bytes are those of the single-device proof for
any number of shards and processes. Arrays with fewer than 2 rows a shard
stay on the single-device path: the whole array (``Mesh.full``) in every
process, on its own device, so every process computes the same values.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List

import torch

from ..core import fft, fri, merkle, poly, quotients
from ..core.m31 import P_INT
from ..framework.component import build_interaction_trace, composition_accumulate
from .fft_sharded import make_sharded_evaluate, make_sharded_interpolate, sharded_extend
from .merkle_sharded import commit_sharded
from .mesh import Mesh, Permutation, Sharded
from .sharded import fractions, prefix_sum


@lru_cache(maxsize=32)
def _permutation(mesh: Mesh, kind: str, log_size: int, log_blowup: int = 0) -> Permutation:
    """The global gathers of the prover, split into per-shard moves:
    "linear" (storage -> coset linear order), "storage" (its inverse) and
    "rotation" (f(p - g) on the blown-up domain)."""
    dev = mesh.home
    if kind == "rotation":
        perm = fft.rotation_permutation(log_size, log_blowup, 1, dev)
    else:
        perm = fft.coset_order_permutation(log_size, dev)
        if kind == "storage":
            perm = torch.argsort(perm)
    return Permutation(mesh, perm)


def _int32(shards: List[torch.Tensor]) -> List[torch.Tensor]:
    return [None if s is None else s.to(torch.int32) for s in shards]


class ShardedOps:
    """Multi-device implementations of the prove pipeline's primitives.
    Each takes tensors or Sharded arrays and returns Sharded arrays where
    the size shards (at least 2 rows a shard), else tensors on the mesh's
    home device, the same in every process (the same values either way)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.D = mesh.size
        self.split_log = mesh.split_log

    def _shardable(self, log_size: int) -> bool:
        return log_size >= self.split_log + 1

    # -- FFT ---------------------------------------------------------------

    def interpolate(self, values, log_size: int):
        if not self._shardable(log_size):
            return fft.interpolate(self.mesh.full(values), log_size)
        return make_sharded_interpolate(self.mesh, log_size)(values)

    def evaluate(self, coeffs, log_size: int):
        if not self._shardable(log_size):
            return fft.evaluate(self.mesh.full(coeffs), log_size)
        return make_sharded_evaluate(self.mesh, log_size)(coeffs)

    def extend_with_coeffs(self, values, log_size: int, blow: int):
        """(coefficients, blown-up evaluation) of a (C, N) array or a list
        of (N,) columns."""
        if isinstance(values, (list, tuple)):
            values = self.mesh.stack(values)
        if not self._shardable(log_size):
            return fft.extend_with_coeffs(self.mesh.full(values), log_size, blow)
        return sharded_extend(self.mesh, values, log_size, blow)

    def combine_eval(self, acc: Dict[int, object], comp_log: int):
        """The composition evaluation: per size the accumulated
        contributions (composition_accumulate), interpolated; zero-padded
        to 2^comp_log and added; evaluated on the composition domain."""
        total = None
        for lg, arr in sorted(acc.items()):
            coeffs = self.interpolate(self.mesh.as_sharded(arr) if self._shardable(lg) else arr,
                                      lg)
            if self._shardable(comp_log):
                padded = self.mesh.pad(coeffs, comp_log)
            else:
                padded = torch.zeros((4, 1 << comp_log), dtype=torch.int32,
                                     device=self.mesh.home)
                padded[:, :1 << lg] = coeffs
            total = padded if total is None else self._add(total, padded)
        return self.evaluate(total, comp_log)

    def _add(self, a, b):
        if isinstance(a, torch.Tensor):
            return ((a.to(torch.int64) + b) % P_INT).to(torch.int32)
        return Sharded(self.mesh, _int32(self.mesh.each(
            lambda i: (a.shards[i].to(torch.int64) + b.shards[i]) % P_INT)))

    # -- Merkle ------------------------------------------------------------

    def commit(self, columns_by_log: Dict[int, object]) -> merkle.MerkleTree:
        if not self._shardable(max(columns_by_log)):
            return merkle.commit({k: self.mesh.full(v) for k, v in columns_by_log.items()})
        return commit_sharded(self.mesh, columns_by_log)

    # -- LogUp interaction -------------------------------------------------

    def interaction(self, component, main_cols: Dict[str, torch.Tensor], elements):
        """build_interaction_trace over the mesh: ([Q_0..Q_{K-1}, S], each
        a (4, N) int32 array, claimed sum host tuple). The fractions are
        pointwise per shard; the prefix sum runs in linear order (a global
        gather there and back)."""
        log_size = component.log_size
        if not self._shardable(log_size):
            return build_interaction_trace(
                component, {k: self.mesh.full(v) for k, v in main_cols.items()}, elements)
        mesh = self.mesh
        main = {k: mesh.as_sharded(v) for k, v in main_cols.items()}
        is_first = torch.zeros(1 << log_size, dtype=torch.int32, device=mesh.home)
        is_first[0] = 1
        q_cols, totals = fractions(mesh, component, main, mesh.shard(is_first), elements)
        lin = mesh.permute(totals, _permutation(mesh, "linear", log_size))
        s_lin, claimed = prefix_sum(mesh, lin)
        s = mesh.permute(s_lin, _permutation(mesh, "storage", log_size))
        n_q = len(q_cols[mesh.local[0]])
        cols = [Sharded(mesh, mesh.each(lambda i: q_cols[i][k])) for k in range(n_q)]
        return cols + [Sharded(mesh, _int32(s))], claimed

    # -- Composition -------------------------------------------------------

    def rotate(self, values, log_size: int, log_blowup: int):
        """values (4, 2^(log_size+log_blowup)) at p - g: the mask of the
        prefix-sum column (fft.rotation_permutation as a global gather)."""
        if not self._shardable(log_size):
            full = self.mesh.full(values)
            return full[:, fft.rotation_permutation(log_size, log_blowup, 1, full.device)]
        perm = _permutation(self.mesh, "rotation", log_size, log_blowup)
        return Sharded(self.mesh, self.mesh.permute(self.mesh.as_sharded(values).shards, perm))

    def composition_accumulate(self, component, ext_main, inter_rows, isf_ext, claimed_sum,
                               elements, alpha, alpha_offset, log_blowup, acc):
        """framework.composition_accumulate on every shard's rows of the
        blown-up domain, at the chunk's offset (one kernel launch a shard on
        a card), S(p - g) from the rotation's global gather: (acc, next
        alpha offset), acc a Sharded (4, N) int32 array updated in place
        (None: a new one), or a tensor below the sharded sizes."""
        n = component.log_size
        args = (claimed_sum, elements, alpha, alpha_offset, log_blowup)
        if not self._shardable(n):
            f = self.mesh.full
            rows = [f(r) for r in inter_rows]
            return composition_accumulate(
                component, {k: f(v) for k, v in ext_main.items()}, rows, rows[-4:],
                fft.rotation_index(n, log_blowup, rows[0].device), f(isf_ext), *args, acc)
        sh = self.mesh.as_sharded
        s_prev = self.rotate(self.mesh.stack(list(inter_rows[-4:])), n, log_blowup)
        main = {k: sh(v) for k, v in ext_main.items()}
        inter = [sh(r) for r in inter_rows]
        isf = sh(isf_ext)
        outs = [None] * self.D
        nxt = alpha_offset
        for i in self.mesh.local:
            outs[i], nxt = composition_accumulate(
                component, {k: v.shards[i] for k, v in main.items()},
                [r.shards[i] for r in inter], list(s_prev.shards[i]), None, isf.shards[i], *args,
                None if acc is None else acc.shards[i], offset=i * isf.chunk)
        return Sharded(self.mesh, outs), nxt

    # -- OODS --------------------------------------------------------------

    def sample_tensor(self, rows, b_lo, b_hi) -> torch.Tensor:
        """poly.sample_tensor of rows that may be Sharded: each shard's
        partial contraction, summed over the mesh (one reduction), mod p.
        (4, C) int64 on the home device, the same in every process."""
        dev = self.mesh.home
        plain = [k for k, r in enumerate(rows) if isinstance(r, torch.Tensor)]
        spread = [k for k, r in enumerate(rows) if not isinstance(r, torch.Tensor)]
        out = torch.empty((4, len(rows)), dtype=torch.int64, device=dev)
        if plain:
            out[:, plain] = poly.sample_tensor([rows[k] for k in plain], b_lo, b_hi).to(dev)
        if spread:
            chunk = rows[spread[0]].chunk
            parts = self.mesh.each(lambda i: poly.sample_tensor(
                [rows[k].shards[i] for k in spread], b_lo, b_hi, offset=i * chunk))
            out[:, spread] = self.mesh.sum(parts) % P_INT
        return out

    # -- Quotients ---------------------------------------------------------

    def accumulate_all(self, log_size: int, columns, groups) -> object:
        """quotients.accumulate_range on every shard's chunk of the domain
        (on a card one kernel launch a shard, at the chunk's offset)."""
        if not self._shardable(log_size):
            return quotients.accumulate_range(log_size, [self.mesh.full(c) for c in columns],
                                              groups)
        cols = [self.mesh.as_sharded(c) for c in columns]
        chunk = cols[0].chunk
        return Sharded(self.mesh, self.mesh.each(lambda i: quotients.accumulate_range(
            log_size, [c.shards[i] for c in cols], groups, offset=i * chunk)))

    # -- FRI ---------------------------------------------------------------

    def fold(self, values, itw, beta):
        """One FRI fold (4, 2M) -> (4, M), int32."""
        if values.shape[1] // 2 < 2 * self.D:
            return fri._fold(self.mesh.full(values), itw, beta).to(torch.int32)
        v, t = self.mesh.as_sharded(values), self.mesh.shard(itw)
        return Sharded(self.mesh, _int32(self.mesh.each(
            lambda i: fri._fold(v.shards[i], t.shards[i], beta))))

    def fold2(self, values, itw1, itw2, beta, beta2):
        """Two folds (beta, then beta2): a radix-4 layer's body."""
        if values.shape[1] // 4 < 2 * self.D:
            full = fri._fold(fri._fold(self.mesh.full(values), itw1, beta), itw2, beta2)
            return full.to(torch.int32)
        v = self.mesh.as_sharded(values)
        t1, t2 = self.mesh.shard(itw1), self.mesh.shard(itw2)
        return Sharded(self.mesh, _int32(self.mesh.each(lambda i: fri._fold(
            fri._fold(v.shards[i], t1.shards[i], beta), t2.shards[i], beta2))))

    def fold_add(self, values, itw, beta, cur):
        """cur + fold(values): an injected FRI input."""
        if values.shape[1] // 2 < 2 * self.D:
            folded = fri._fold(self.mesh.full(values), itw, beta)
            return ((self.mesh.full(cur).to(torch.int64) + folded) % P_INT).to(torch.int32)
        v, t = self.mesh.as_sharded(values), self.mesh.shard(itw)
        c = self.mesh.as_sharded(cur)
        return Sharded(self.mesh, _int32(self.mesh.each(lambda i: (
            c.shards[i].to(torch.int64) + fri._fold(v.shards[i], t.shards[i], beta)) % P_INT)))
